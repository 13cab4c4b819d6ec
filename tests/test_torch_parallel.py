"""The port's data parallelism (`devis_torch.parallel`, DDP over gloo) on the
CPU.

One spawn of 2 processes (a join timeout of its own, so that a hang fails
here) runs, on the tiny DeVIS of `test_torch_engine.py` with its weights:
  * one DDP step at a global batch of 2 clips, a clip a rank, held to the
    port's 1-process step on the same 2 clips (every loss to 1e-5, every
    gradient to 1e-5 of its norm) and to the JAX package's loss and
    gradients of those 2 clips at `test_torch_engine.py`'s tolerances;
  * the same step with the recomputation flags on (bit-identical
    gradients), the NaN guard with the non-finite clip on one rank only
    (neither rank steps), and the metric logger's cross-rank averages;
  * `inference_vis` over 3 videos on 2 ranks (padded: one video on both)
    against 1 process: the same records after `accumulate_results`,
    TrackMAP to 1e-9;
  * the CLI (`main`) on `test_torch_cli.py`'s COCO tree: one step of a
    global batch of 2 images, checkpoints written once, `evaluate_coco` over
    both ranks equal on each and equal to one process's evaluation of the
    saved weights (to 1e-9), and the checkpoint resumed in one process.
The one-process references of the step, the tracks and the CLI run in rank
0 once it has left the group, so the test's own process only waits for
the JAX package's compile meanwhile.
`local_batch_size`, `accumulate_results` and the ranks' video shards are
held to the JAX package's own functions without a process group.
"""
import os
import pickle
import socket
import traceback

import numpy as np
import pytest
import torch

from .test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 2
JOIN_TIMEOUT_S = 110.0
TRACK_OPTS = ["TEST.NUM_OUT", 4, "TEST.CLIP_TRACKING.STRIDE", 1,
              "INPUT.MIN_SIZE_TEST", 48, "INPUT.MAX_SIZE_TEST", 64]


def _val_dataset():
    from devis_torch.datasets.synthetic import SyntheticVISValDataset
    return SyntheticVISValDataset(num_frames=2, stride=1, n_videos=3, video_len=4,
                                  size=(40, 56), n_inst=2, min_size=48, max_size=64)


def _cfgs(remat: bool = False):
    """(the engine test's port cfg, the same with the tracker's settings)."""
    from devis_torch.config import get_cfg_defaults

    from .test_torch_engine import _cfg
    base = _cfg(get_cfg_defaults)
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_list(TRACK_OPTS)
    if remat:
        cfg.TPU.TRANSFORMER_GRADIENT_CHECKPOINT = True
    cfg.freeze()
    return cfg


def _two_clips():
    from devis_torch.util.synthetic import synthetic_clip_batch

    from .test_torch_engine import H, NUM_CLASSES, T, W
    return synthetic_clip_batch(seed=11, num_frames=T, canvas=(H, W), valid_hw=(56, 80),
                                n_instances=2, max_instances=3,
                                num_classes=NUM_CLASSES - 1, batch=WORLD)


def _coco_argv(tmp: str, *extra):
    """The COCO CLI run of `test_torch_cli.py`'s COCO test on its tree."""
    from .test_torch_cli import NARROW, ROOT
    return (["--config-file", os.path.join(ROOT, "configs", "deformable_mask_head",
                                           "deformable_mask_head_R_50.yaml")] + list(extra)
            + NARROW + ["MODEL.WEIGHTS", "", "DATASETS.DATA_PATH", os.path.join(tmp, "coco"),
                        "OUTPUT_DIR", os.path.join(tmp, "out"), "MODEL.NUM_QUERIES", "12",
                        "MODEL.TRANSFORMER.ENCODER_LAYERS", "1",
                        "MODEL.TRANSFORMER.DECODER_LAYERS", "2",
                        "MODEL.LOSS.MASK_AUX_LOSS", "[0]", "TEST.NUM_OUT", "5",
                        "INPUT.SCALE_FACTOR_TRAIN", "0.125", "INPUT.MIN_SIZE_TEST", "64",
                        "INPUT.MAX_SIZE_TEST", "96", "SOLVER.EPOCHS", "1", "SOLVER.BATCH_SIZE", "2"])


def _one_process(inputs, tmp: str) -> dict:
    """In one process (no group): the step on both clips, its tracks, the
    evaluation of the CLI's saved weights and their resume."""
    from devis_torch.engine import create_train_state, make_train_step
    from devis_torch.inference import build_tracker, inference_vis
    from devis_torch.main import main
    from devis_torch.models import build_model

    from .test_torch_engine import NUM_CLASSES, STEPS_PER_EPOCH
    cfg = _cfgs()
    one = build_model(NUM_CLASSES, cfg, device="cpu")
    one.load_state_dict(inputs["state"], strict=True)
    state = create_train_state(cfg, one, STEPS_PER_EPOCH)
    _, metrics = make_train_step(one, cfg)(state, inputs["batch"])
    got = {"metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {n: p.grad.clone() for n, p in one.named_parameters()}}
    one.eval()
    got["tracks"] = inference_vis(build_tracker(cfg, one, device="cpu"), _val_dataset(),
                                  verbose=False)
    ckpt_dir = os.path.join(tmp, "out", "checkpoint")
    got["eval"] = main(_coco_argv(tmp, "--eval-only") + ["MODEL.WEIGHTS", ckpt_dir],
                       device="cpu")["eval"]
    run = main(_coco_argv(tmp, "--resume", ckpt_dir)
               + ["SOLVER.EPOCHS", "2", "TEST.START_EVAL_EPOCH", "3",
                  "OUTPUT_DIR", os.path.join(tmp, "resumed")], device="cpu")
    got["resume"] = (run["start_epoch"], run["epochs"][0]["step"])
    return got


def _rank_main(rank: int, port: int, tmp: str) -> None:
    """One rank: the DDP steps, the logger, `inference_vis` and the CLI;
    then rank 0, out of the group, the one-process references. Each rank
    writes what the test compares; errors go to `error{rank}.txt`."""
    try:
        torch.set_num_threads(1)
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                          WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank))
        from devis_torch.engine import create_train_state, make_train_step
        from devis_torch.inference import build_tracker, inference_vis
        from devis_torch.models import build_model
        from devis_torch.parallel import (data_parallel, destroy_process_group,
                                          init_process_group, shard_items)
        from devis_torch.util.misc import MetricLogger

        from .test_torch_engine import NUM_CLASSES, STEPS_PER_EPOCH
        device = torch.device("cpu")
        assert init_process_group(device) == device
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        # the rank's clips of the global batch, items rank, rank + world, ...
        batch = {k: {kk: np.stack(shard_items(vv)) for kk, vv in v.items()}
                 if isinstance(v, dict) else np.stack(shard_items(v))
                 for k, v in inputs["batch"].items()}
        out = {}

        def step_once(remat, batch):
            cfg = _cfgs(remat)
            model = build_model(NUM_CLASSES, cfg, device="cpu")
            model.load_state_dict(inputs["state"], strict=True)
            state = create_train_state(cfg, model, STEPS_PER_EPOCH)
            before = {k: v.clone() for k, v in model.state_dict().items()}
            state, metrics = make_train_step(data_parallel(model, device), cfg)(state, batch)
            moved = any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())
            return model, state, metrics, moved

        model, state, metrics, _ = step_once(False, batch)
        out["metrics"] = {k: float(v) for k, v in metrics.items()}
        out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
        rmodel = step_once(True, batch)[0]
        out["remat_grads"] = {n: p.grad.clone() for n, p in rmodel.named_parameters()}
        # the NaN guard: the non-finite clip is rank 1's alone
        bad = {k: (dict(v) if isinstance(v, dict) else v.copy()) for k, v in batch.items()}
        if rank == 1:
            bad["images"][0, 0, 0, 0, 0] = np.nan
        _, nstate, nmetrics, moved = step_once(False, bad)
        out["nan"] = {"finite": float(nmetrics["finite"]), "step": nstate.step, "moved": moved}
        # the metric logger: rank r logs r + 1 and 10 (r + 1)
        logger = MetricLogger()
        logger.update(a=rank + 1.0)
        logger.update(a=10.0 * (rank + 1))
        logger.synchronize_between_processes()
        out["logger"] = (logger.a.count, logger.a.total, logger.a.global_avg)
        # video in, tracks out over the ranks
        model.eval()
        res = inference_vis(build_tracker(_cfgs(), model, device="cpu"), _val_dataset(),
                            verbose=False)
        out["results"], out["eval"] = res["results"], res.get("eval")
        # the CLI: a COCO epoch of one global batch of 2 images, then its
        # evaluation of 2 images, an image a rank
        from devis_torch.main import main
        run = main(_coco_argv(tmp), device="cpu")
        out["cli"] = {"steps": [e["step"] for e in run["epochs"]],
                      "eval": run["epochs"][0]["eval"], "best": run["best_stats"]}
        destroy_process_group()
        if rank == 0:
            for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
                del os.environ[k]
            out["one"] = _one_process(inputs, tmp)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:                                    # noqa: BLE001
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(tmp: str):
    """Starts the ranks; returns a function that joins them (failing after
    JOIN_TIMEOUT_S in all) and loads what they wrote."""
    import time
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, tmp), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    start = time.monotonic()

    def join():
        for p in procs:
            p.join(max(1.0, JOIN_TIMEOUT_S - (time.monotonic() - start)))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
        errors = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
                  if f.startswith("error")]
        assert not hung, f"ranks {hung} did not finish in {JOIN_TIMEOUT_S} s"
        assert not errors and all(p.exitcode == 0 for p in procs), "\n".join(errors)
        outs = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
    return join


def test_two_ranks_match_one_process_and_the_jax_package(tmp_path):
    import jax
    import jax.numpy as jnp

    from devis_torch.config import get_cfg_defaults
    from devis_torch.evaluation.track_map import evaluate_vis
    from devis_tpu.config import get_cfg_defaults as jax_cfg
    from devis_tpu.engine import create_train_state as jax_state

    from .test_torch_engine import (STEPS_PER_EPOCH, T, _cfg, _make_pair,
                                    check_step_against_jax, jax_clip_value_and_grad)

    from devis_torch.util import checkpoint as ckpt
    from devis_torch.util.fixtures import write_coco_tree

    jmodel, variables, tmodel = _make_pair()
    batch = _two_clips()
    torch.save({"state": tmodel.state_dict(), "batch": batch}, str(tmp_path / "inputs.pt"))
    write_coco_tree(str(tmp_path / "coco"), seed=3, n_train=4, n_val=2,
                    sizes=((60, 80), (80, 60)))
    join = _spawn(str(tmp_path))

    # meanwhile: the JAX loss and gradients of the 2 clips. Each clip's loss
    # is normalised by its own count n_i; the batch shares the mean count, so
    # the batch's loss, each of its terms and its gradient are the clips'
    # weighted by n_i / (n_0 + n_1) (every weighted term is a sum over the
    # clip divided by the normaliser, `devis_tpu/models/criterion.py`)
    fn = jax_clip_value_and_grad(jmodel, variables)
    params = jax_state(_cfg(jax_cfg), variables, STEPS_PER_EPOCH).params
    counts = [float(batch["targets"]["exists"][b].sum() * T) for b in range(WORLD)]
    weights = [c / sum(counts) for c in counts]
    jtotal, jlosses, jgrads = 0.0, {}, None
    for b, w in enumerate(weights):
        targets = jax.tree.map(lambda x: jnp.asarray(x[b]), batch["targets"])
        (tot, losses), grads = fn(params, jnp.asarray(batch["images"][b]),
                                  jnp.asarray(batch["pad_mask"][b]), targets)
        jtotal += w * float(tot)
        for k, v in losses.items():
            jlosses[k] = jlosses.get(k, 0.0) + w * float(v)
        grads = jax.tree.map(lambda g: w * np.asarray(g, np.float64), grads)
        jgrads = grads if jgrads is None else jax.tree.map(np.add, jgrads, grads)
    jgrads = jax.tree.map(lambda g: g.astype(np.float32), jgrads)

    r0, r1 = join()
    one = r0["one"]               # the port in one process on the same inputs
    one_metrics, one_grads, one_tracks = one["metrics"], one["grads"], one["tracks"]

    # the DDP step against the 1-process step
    assert set(r0["metrics"]) == set(one_metrics)
    for k, v in one_metrics.items():
        assert r0["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
        assert r1["metrics"][k] == r0["metrics"][k], k       # the ranks agree
    for name, g in one_grads.items():
        for r in (r0, r1):
            assert float((r["grads"][name] - g).norm()) <= 1e-5 * float(g.norm()) + 1e-12, name
    # recomputation under DDP: the same gradients to the bit
    for name, g in r0["grads"].items():
        assert torch.equal(r0["remat_grads"][name], g), name
    # and against the JAX package
    for name, p in tmodel.named_parameters():
        p.grad = r0["grads"][name]
    check_step_against_jax(_cfg(get_cfg_defaults), tmodel, r0["metrics"], jtotal, jlosses,
                           jgrads)
    # a non-finite loss on one rank: no rank steps
    for r in (r0, r1):
        assert r["nan"] == {"finite": 0.0, "step": 0, "moved": False}
    # the logger's averages are over both ranks: (1 + 10 + 2 + 20) / 4
    assert r0["logger"] == r1["logger"] == (4, 33.0, 8.25)

    # tracks over 2 ranks against 1 process
    def key(rec):
        return (rec["video_id"], rec["category_id"], rec["score"])
    assert len(one_tracks["results"]) > 0
    for r in (r0, r1):
        assert sorted(r["results"], key=key) == sorted(one_tracks["results"], key=key)
        assert {v["video_id"] for v in r["results"]} == {1, 2, 3}
        for k in ("AP", "AP50", "AP75", "AR"):
            assert abs(r["eval"][k] - one_tracks["eval"][k]) <= 1e-9, k
    gt = _val_dataset().gt_dict()
    assert evaluate_vis(gt, r0["results"])["AP"] == pytest.approx(one_tracks["eval"]["AP"],
                                                                  abs=1e-9)

    # the CLI over 2 ranks: one step of the global batch (an image a rank),
    # one set of checkpoints (rank 0's), the same evaluation on both ranks,
    # equal to one process's evaluation of the saved weights; the
    # checkpoint resumes in one process
    out = str(tmp_path / "out")
    assert r0["cli"] == r1["cli"] and r0["cli"]["steps"] == [1]
    assert set(r0["cli"]["eval"]) == {"bbox", "segm"}
    for d in ("checkpoint", "checkpoint_epoch_0", "checkpoint_best_coco_ap"):
        want = [ckpt.STATE_FILE] + (["meta.json"] if d == "checkpoint" else [])
        assert sorted(os.listdir(os.path.join(out, d))) == sorted(want), d
    saved = ckpt.load_checkpoint(os.path.join(out, "checkpoint"))
    assert saved["step"] == 1 and len(saved["rng"]["dropout_ranks"]) == WORLD
    for task in ("bbox", "segm"):
        for k, v in one["eval"][task].items():
            assert abs(r0["cli"]["eval"][task][k] - v) <= 1e-9, (task, k)
    assert one["resume"] == (1, 2)            # start epoch, then the step after it


def test_batch_sizes_shards_and_dedup_match_the_jax_package():
    import jax

    from devis_torch.parallel import (accumulate_results, local_batch_size, padded_shard,
                                      shard_items)
    from devis_tpu.parallel import local_batch_size as jax_local_batch_size
    from devis_tpu.parallel import make_mesh
    from devis_tpu.parallel.multihost import accumulate_results as jax_accumulate

    for n in (1, 2, 4, 8):
        mesh = make_mesh(n)
        for global_batch in (n, 2 * n, 8):
            if global_batch % n == 0:
                assert local_batch_size(global_batch, n) == \
                    jax_local_batch_size(global_batch, mesh)
        if n > 1:
            with pytest.raises(AssertionError):
                jax_local_batch_size(n + 1, mesh)
            with pytest.raises(ValueError, match="not divisible"):
                local_batch_size(n + 1, n)
    assert local_batch_size(6) == jax_local_batch_size(6, None) == 6    # no group
    assert len(jax.devices()) == 8
    # the ranks' shards of 5 videos: `devis_tpu/inference.py:231-235`'s rule
    for world in (1, 2, 3, 4, 7):
        for r in range(world):
            per = -(-5 // world)
            assert padded_shard(5, r, world) == [(r + k * world) % 5 for k in range(per)]
        assert {i for r in range(world) for i in padded_shard(5, r, world)} == set(range(5))
    assert padded_shard(0, 1, 2) == []
    # a global batch: rank r takes items r, r + world, ...
    items = list(range(6))
    assert [shard_items(items, r, 3) for r in range(3)] == [[0, 3], [1, 4], [2, 5]]
    assert [a.tolist() for a in shard_items(np.arange(12).reshape(6, 2), 1, 2)] == \
        [[2, 3], [6, 7], [10, 11]]
    # first-wins dedup by video id, record for record the JAX function's
    rs = np.random.RandomState(0)
    per_rank = [[{"video_id": int(v), "score": float(rs.rand()), "rank": r}
                 for v in rs.randint(0, 6, size=5)] for r in range(3)]
    assert accumulate_results(per_rank) == jax_accumulate(per_rank)
    assert accumulate_results([[]]) == jax_accumulate([[]]) == []
