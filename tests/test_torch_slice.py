"""The PyTorch port's whole DeVIS clip-inference slice against the JAX
package's `impl='xla'` twin, at a small size on the CPU.

Weights are numpy draws from a seed over the JAX parameter tree, carried to
the port with `from_jax_params` and loaded strictly. Both sides run in f32
with TF32 off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

T, H, W = 2, 64, 96          # canvas
H_VALID, W_VALID = 56, 80    # the clip's frames; the rest of the canvas is padding


def _cfg(get_cfg_defaults):
    cfg = get_cfg_defaults()
    cfg.DATASETS.TYPE = "vis"
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.BBX_GRADIENT_PROP = True
    cfg.MODEL.LOSS.MASK_AUX_LOSS = [0]
    cfg.MODEL.NUM_QUERIES = 4
    cfg.MODEL.HIDDEN_DIM = 128
    cfg.MODEL.DIM_FEEDFORWARD = 256
    cfg.MODEL.TRANSFORMER.ENCODER_LAYERS = 1
    cfg.MODEL.TRANSFORMER.DECODER_LAYERS = 1
    cfg.MODEL.DEVIS.NUM_FRAMES = T
    cfg.TEST.NUM_OUT = 4
    cfg.freeze()
    return cfg


def _flatten(variables):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]:
        keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        flat["/".join(str(k) for k in keys)] = np.asarray(leaf)
    return flat


def random_variables(template, seed: int):
    """numpy draws over a JAX variable tree: kernels ~ N(0, 1/fan_in),
    biases and offsets' kernels nonzero (so taps land off the pixel grid),
    frozen batch norms with positive variances."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = leaf.shape
        if "frozen" in str(getattr(path[0], "key", path[0])):
            if name == "running_var":
                return rs.uniform(0.5, 1.5, shape).astype(np.float32)
            base = 1.0 if name == "weight" else 0.0
            return (base + 0.1 * rs.randn(*shape)).astype(np.float32)
        if name in ("kernel", "weight") and len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            return (rs.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*shape)).astype(np.float32)
        if name in ("query_embed", "level_embed", "temporal_embed"):
            return rs.randn(*shape).astype(np.float32)
        return (0.1 * rs.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, template)


class _Video:
    def __init__(self, frames, real_video_length=None):
        self.frames = frames
        self.real_video_length = real_video_length

    def load_clip(self, clip_idx):
        return self.frames


@pytest.fixture(scope="module")
def pair():
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.models import build_model as jax_build
    from devis_torch.config import get_cfg_defaults
    from devis_torch.models import build_model
    from devis_torch.util.weights import from_jax_params

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jmodel = jax_build(num_classes=41, cfg=_cfg(jax_cfg), impl="xla")
    imgs = jnp.zeros((T, H, W, 3), jnp.float32)
    pad = jnp.zeros((T, H, W), bool)
    template = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), imgs, pad, train=False))
    variables = random_variables(template, seed=0)
    tmodel = build_model(41, _cfg(get_cfg_defaults), device="cpu")
    tmodel.load_state_dict(from_jax_params(_flatten(variables)), strict=True)
    return jmodel, variables, tmodel


def _inputs():
    rs = np.random.RandomState(1)
    frames = (rs.rand(T, H_VALID, W_VALID, 3) * 255).astype(np.uint8)
    images = np.zeros((T, H, W, 3), np.uint8)
    images[:, :H_VALID, :W_VALID] = frames
    mean = np.asarray([0.485, 0.456, 0.406], np.float32)
    std = np.asarray([0.229, 0.224, 0.225], np.float32)
    norm = (images.astype(np.float32) / 255.0 - mean) / std
    pad = np.ones((T, H, W), bool)
    pad[:, :H_VALID, :W_VALID] = False
    return frames, norm, pad


def _close(got, want, what):
    # f32 on both sides; summation order and conv algorithms differ, so
    # agreement is to 1e-3 of the output's scale
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= 1e-3 * max(np.abs(want).max(), 1e-12), (what, err)


def test_forward_matches_jax(pair):
    jmodel, variables, tmodel = pair
    _, norm, pad = _inputs()
    jout, jres = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, train=False))(
        variables, jnp.asarray(norm), jnp.asarray(pad))
    with torch.no_grad():
        tout, tres = tmodel(torch.from_numpy(norm), torch.from_numpy(pad))
    _close(tout["pred_logits"], jout["pred_logits"], "pred_logits")
    _close(tout["pred_boxes"], jout["pred_boxes"], "pred_boxes")
    probs = np.sort(np.asarray(jres["scores"]).mean(0))
    assert np.all(np.diff(probs) > 1e-4), "top-k scores must have no ties"
    for k in ("labels", "query_top_k_indexes", "mask_gather"):
        np.testing.assert_array_equal(tres[k].numpy(), np.asarray(jres[k]), k)
    for k in ("scores", "boxes", "center_points", "masks"):
        _close(tres[k], jres[k], k)


@pytest.mark.parametrize("real_video_length", [None, 1])
def test_infer_fn_fetch_matches_jax(pair, real_video_length):
    """A video shorter than the clip scores trajectories over its real
    frames only (`clip_length`)."""
    from devis_torch.inference import VISInferFn
    from devis_tpu.inference import VISInferFn as JaxVISInferFn
    jmodel, variables, tmodel = pair
    frames, _, _ = _inputs()
    video = _Video(frames, real_video_length)
    want = JaxVISInferFn(jmodel, variables, T, [(H, W)])(video, 0)
    got = VISInferFn(tmodel, T, [(H, W)], device="cpu")(video, 0)
    assert set(got) == set(want)
    assert got["valid_hw"] == want["valid_hw"]
    for k in ("labels", "mask_gather"):
        np.testing.assert_array_equal(got[k], want[k], k)
    # the JAX fetch rounds boxes and scores to f16 (its transfer packing):
    # within the 1e-3 relative bound
    for k in ("scores", "boxes", "center_points"):
        _close(got[k], want[k], k)
    assert got["mask_logits"].dtype == torch.float8_e4m3fn
    g = got["mask_logits"].float().numpy()
    w = np.asarray(want["mask_logits"]).astype(np.float32)
    assert g.shape == w.shape
    # f8 e4m3 keeps 3 mantissa bits: two roundings of nearly equal logits
    # differ by at most one step, 2^-3 of the magnitude (2^-9 near zero)
    step = np.maximum(np.abs(w), np.abs(g)) * 2.0 ** -3 + 2.0 ** -9
    assert np.all(np.abs(g - w) <= step)
