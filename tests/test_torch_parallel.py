"""Data-parallel training of the port (`metro_pose3d_tpu_torch/parallel/`)
on the CPU: real ranks, each a process of this file (`python
test_torch_parallel.py <scenario> <rank> <world> <dir>`), joined in a Gloo
process group through a `file://` rendezvous in the run's directory.

  * steps: two train steps of 2 and 4 ranks against two steps of the JAX
    package's `make_train_step` (no mesh) on the global batch the ranks'
    batches make in rank order (8 3D + 8 2D rows, from a 2D dataset with
    NaN joints; the ranks hold different numbers of valid joints), at
    `test_torch_train.py`'s tolerances; against the port's own step in one
    process on that batch, at reduction-order tolerances; every rank's
    parameters and BN statistics bit for bit equal. Ghost BN against JAX
    with groups of half the local batch, groups that span ranks (twice the
    local batch) and groups that straddle them unevenly (each rank's first
    rows only), and a group size that does not divide the global batch.
  * trainer: `train()` on 2 ranks over `SyntheticDataset`, cut at step 6
    (checkpoint and validation at 3 and 6) and resumed to 10, against an
    uninterrupted 2-rank run that `main --train` makes under torchrun's
    environment (it joins the group through `env://` and leaves it); the
    files that each rank wrote.
  * predict: the 2 ranks' `predict_dataset` blocks against the
    single-process dump, `main --test` on 2 ranks (rank 0 writes the
    gathered dump) against one process, and replicated validation.
  * initialization: no-ops, an unreachable rendezvous, the batch guards.

A spawn's ranks write their output to files, and the tests read them. A
spawn runs once a test run: under pytest-xdist the first worker that needs
it runs it while the others wait on a lock, then all read its files. Every
spawn has its own timeout, after which its ranks are killed and reaped.
"""
from __future__ import annotations

import fcntl
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SPAWN_TIMEOUT = 300  # seconds, each spawn: ranks that have not ended are killed
N_OCC = 64
STEPS = 2
TINY = {
    "model.backbone": "tiny",
    "model.proc_side": "64",
    "model.depth": "4",
    "model.compute_dtype": "float32",
    "data.source_side": "128",
    "data.workers": "2",
    "data.host_prep": "python",
    "train.batch_size": "8",
    "train.batch_size_2d": "8",
    "train.warmup_steps": "0",
    "train.validate_every": "0",
    "eval.batch_size": "8",
}
TRAIN_RUN = {
    **TINY,
    "train.batch_size_2d": "0",
    "train.num_steps": "10",
    "train.checkpoint_every": "3",
    "train.validate_every": "3",
    "train.validate_batches": "1",
    "train.log_every": "2",
}
CUT_AT = 6
N_TEST = 20
# One process against N on the same global batch: the same arithmetic but
# for the order of the sums in batch norm's moments, the losses and the
# gradient mean, float32 roundoff (measured: losses 1e-7 relative, grad_norm
# 4e-7, BN statistics 1.2e-7). Adam divides each gradient by its own
# magnitude, so where a gradient is as small as Adam's epsilon (1e-8) its
# roundoff moves the update by a share of the rate: measured, 30 of 150733
# parameters moved by more than 1e-7, the most by 0.057 lr.
SAME_RTOL = {"loss": 1e-5, "loss3d": 1e-5, "loss2d": 1e-5, "grad_norm": 1e-4}
SAME_STATS_ATOL = 1e-6
SAME_PARAM_ATOL = 1e-7  # for all but SAME_PARAM_OUTLIERS of the parameters
SAME_PARAM_OUTLIERS = 1e-3
SAME_PARAM_MAX_LR = 0.1  # the rest, in units of the learning rate
# ghost BN cases, by world: name -> (model.bn_group_size, the rows each rank
# takes from the front of its batch, None for all); the global batch is the
# ranks' rows in rank order. "ghost": groups inside a rank; "span": groups
# of two ranks' rows; "straddle": groups that cross a rank boundary
# part-way (global 12 rows, groups of 4).
GHOST_CASES = {
    2: {"ghost": (4, None), "span": (16, None), "straddle": (4, 6)},
    4: {"span": (8, None), "straddle": (4, 3)},
}
ACROSS_RANKS = [(w, c) for w, cases in GHOST_CASES.items() for c in cases if c != "ghost"]
ACROSS_IDS = [f"{w}ranks-{c}" for w, c in ACROSS_RANKS]
INDIVISIBLE_GS = 3  # no global batch of these tests is a multiple of it


# --- the ranks ---------------------------------------------------------------


def _port_cfg(over: dict):
    from metro_pose3d_tpu_torch.config import Config, apply_overrides

    return apply_overrides(Config(), over)


def _write_audit(logdirs, log: list):
    """Record the file writes, renames and removals under `logdirs`."""
    roots = tuple(os.path.abspath(d) + os.sep for d in logdirs)

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writing = (any(c in mode for c in "wax+") if isinstance(mode, str)
                       else bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
            paths = [path] if writing else []
        elif event in ("os.rename", "os.remove", "shutil.rmtree"):
            paths = [args[0]]
        else:
            return
        for p in paths:
            if isinstance(p, (str, bytes, os.PathLike)):
                p = os.path.abspath(os.fsdecode(p))
                if p.startswith(roots):
                    log.append((event, p))

    sys.addaudithook(hook)


def _run_steps(rank: int, world: int, outdir: str) -> dict:
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.parallel.distributed import local_batch_slice
    from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
    from metro_pose3d_tpu_torch.train.loop import make_train_step
    from metro_pose3d_tpu_torch.train.state import create_train_state

    setup = torch.load(os.path.join(outdir, "setup.pt"), weights_only=True)
    bank = np.load(os.path.join(outdir, "bank.npy"))
    batches = [dict(np.load(os.path.join(outdir, f"batch{k}_rank{rank}.npz")))
               for k in range(STEPS)]
    local = len(batches[0]["is_3d"])
    cases = {"plain": ({}, None)}
    for case, (gs, rows) in GHOST_CASES[world].items():
        cases[case] = ({"model.bn_group_size": str(gs)}, rows)
    for case, (extra, rows) in cases.items():
        cfg = _port_cfg({**TINY, **extra})
        state = create_train_state(cfg, "cpu")
        state.load_state_dict(setup["state"])
        step = make_train_step(cfg, 0, occluder_bank=pack_occluder_bank_for(bank, "cpu"))
        metrics = [{k: float(v) for k, v in step(state, batch_to_device(
            {key: v[:rows] for key, v in b.items()}, "cpu")).items()} for b in batches]
        torch.save({"metrics": metrics, "model": state.model.state_dict(), "step": state.step},
                   os.path.join(outdir, f"{case}_rank{rank}.pt"))
    # a group size that does not divide the global batch raises, as in JAX
    odd = init_metro_model(_port_cfg({**TINY, "model.bn_group_size": str(INDIVISIBLE_GS)}).model,
                           0, "cpu", train=True)
    try:
        odd(torch.zeros(local, 64, 64, 3))
        indivisible_error = None
    except ValueError as e:
        indivisible_error = str(e)
    try:
        local_batch_slice(4 * world + 1)
        guard = None
    except ValueError as e:
        guard = str(e)
    return {"indivisible_error": indivisible_error, "guard_error": guard,
            "slice": list(local_batch_slice(8 * world))}


def _main_argv(mode: str, logdir: str) -> list:
    """`main`'s command line for TRAIN_RUN on the registry's synthetic
    dataset (the one `_trainer_dataset` makes)."""
    flags = {**TRAIN_RUN, "data.dataset": "synthetic", "data.dataset_2d": "",
             "data.synthetic_n_train": "32", "data.synthetic_n_test": str(N_TEST),
             "train.logdir": logdir}
    return [mode, *(f"--{k}={v}" for k, v in flags.items())]


def _trainer_dataset():
    from metro_pose3d_tpu_torch.data.synthetic import SyntheticDataset

    return SyntheticDataset(n_train=32, n_test=N_TEST)


def _run_main_train(rank: int, outdir: str) -> dict:
    """The uninterrupted run: `main --train` under torchrun's environment,
    with no group up before it. `train()`'s result is kept by wrapping it."""
    from metro_pose3d_tpu_torch import main as cli
    from metro_pose3d_tpu_torch.train import trainer

    states, real = [], trainer.train

    def train(*args, **kwargs):
        states.append(real(*args, **kwargs))
        return states[-1]

    trainer.train = train
    try:
        rc = cli.main(_main_argv("--train", os.path.join(outdir, "whole")), device="cpu")
    finally:
        trainer.train = real
    torch.save(states[0].model.state_dict(), os.path.join(outdir, f"whole_rank{rank}.pt"))
    return {"whole_rc": rc, "whole_step": states[0].step,
            "whole_left_group": not torch.distributed.is_initialized()}


def _run_trainer(rank: int, world: int, outdir: str) -> dict:
    import dataclasses

    from metro_pose3d_tpu_torch import main as cli
    from metro_pose3d_tpu_torch.evaluation.predict import predict_dataset, save_predictions
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.train.trainer import train, validate

    cut = os.path.join(outdir, "cut")
    cfg = _port_cfg(TRAIN_RUN)
    ds = _trainer_dataset()
    out = {}
    for name, max_steps in (("cut", CUT_AT), ("resumed", None)):
        run_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, logdir=cut))
        state = train(run_cfg, ds, max_steps=max_steps, device="cpu")
        out[f"{name}_step"] = state.step
        if name != "cut":
            torch.save(state.model.state_dict(), os.path.join(outdir, f"{name}_rank{rank}.pt"))
    model = init_metro_model(cfg.model, 0, "cpu")
    result = predict_dataset(cfg, model, ds)
    save_predictions(result, os.path.join(outdir, f"pred_rank{rank}.npz"))
    out["val_mpjpe"] = validate(cfg, model, ds, n_batches=1)
    # the group is up, so main joins none: it predicts this rank's block of
    # the uninterrupted run's weights, and rank 0 writes whole/predictions.npz
    out["test_rc"] = cli.main(_main_argv("--test", os.path.join(outdir, "whole")),
                              device="cpu")
    return out


def _rank_main(scenario: str, rank: int, world: int, outdir: str) -> None:
    torch.set_num_threads(2)
    from metro_pose3d_tpu_torch.parallel.distributed import (
        initialize_distributed, process_index_count,
    )

    first = {}
    if scenario == "trainer":
        writes = []
        _write_audit([os.path.join(outdir, d) for d in ("cut", "whole")], writes)
        first = _run_main_train(rank, outdir)
        for k in _LAUNCH_ENV:
            del os.environ[k]
    rdv = f"file://{os.path.join(outdir, 'rendezvous')}"
    made = initialize_distributed(rank, world, init_method=rdv, backend="gloo",
                                  timeout=SPAWN_TIMEOUT, device="cpu")
    again = initialize_distributed(rank, world, init_method=rdv, backend="gloo",
                                   timeout=SPAWN_TIMEOUT, device="cpu")
    try:
        out = {"made": made, "again": again, "index_count": list(process_index_count()),
               **first}
        out.update((_run_steps if scenario == "steps" else _run_trainer)(rank, world, outdir))
        if scenario == "trainer":
            out["writes"] = writes
        with open(os.path.join(outdir, f"{scenario}_rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


# --- spawning ------------------------------------------------------------------


def _spawn(scenario: str, world: int, outdir: str, torchrun_env: bool = False) -> list:
    """Run `world` ranks of `scenario` -> their json outputs; with
    `torchrun_env` each rank gets the environment that `torchrun` would set.
    Fails, after killing and reaping every rank, where one fails or the
    spawn outlasts SPAWN_TIMEOUT."""
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_ENV}
    env.update(OMP_NUM_THREADS="2", PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    port = str(_free_port())
    procs, logs = [], []
    try:
        for r in range(world):
            launch = (dict(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=port) if torchrun_env else {})
            logs.append(open(os.path.join(outdir, f"{scenario}_rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), scenario, str(r), str(world), outdir],
                cwd=REPO, env={**env, **launch}, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + SPAWN_TIMEOUT
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(outdir, f"{scenario}_rank{r}.log")) as f:
                text = f.read()
            raise AssertionError(f"rank {r}/{world} of {scenario} ended with {p.returncode}:\n"
                                 f"{text[-4000:]}")
    outs = []
    for r in range(world):
        with open(os.path.join(outdir, f"{scenario}_rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def _once(tmp_path_factory, name: str, produce) -> str:
    """The directory of `produce(dir)`, made once a test run: the xdist
    workers of a run share the parent of their temporary roots, and a lock
    there lets the first produce while the others wait."""
    root = tmp_path_factory.getbasetemp()
    if "PYTEST_XDIST_WORKER" in os.environ:
        root = root.parent
    out, done = root / name, root / f"{name}.done"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not done.exists():
                shutil.rmtree(out, ignore_errors=True)
                out.mkdir()
                produce(str(out))
                done.touch()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return str(out)


# --- the steps: N ranks, JAX, one process -------------------------------------


def _flat_dict(sd: dict) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _produce_steps(world: int, outdir: str) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from metro_pose3d_tpu.config import Config, apply_overrides
    from metro_pose3d_tpu.pipeline.occluders import make_procedural_occluders
    from metro_pose3d_tpu.train import loop as jloop
    from metro_pose3d_tpu.train.state import create_train_state as jax_create_train_state
    from metro_pose3d_tpu_torch.convert import state_dict_from_flax, train_state_from_flax
    from metro_pose3d_tpu_torch.pipeline.device import batch_to_device, pack_occluder_bank_for
    from metro_pose3d_tpu_torch.train.loop import make_train_step
    from metro_pose3d_tpu_torch.train.state import create_train_state
    from metro_pose3d_tpu_torch.train.trainer import mixed_batch_iterator
    from test_torch_pipeline import JaxSynth

    cfg = apply_overrides(Config(), TINY)
    bank = make_procedural_occluders(N_OCC, 96)
    np.save(os.path.join(outdir, "bank.npy"), bank)

    class Gappy2D(JaxSynth):
        """2D examples whose annotation misses joints as MPII's does, a
        number that varies from example to example: example i loses i % 4
        more of its joints (NaN, invalid)."""

        def train_example(self, i):
            ex = super().train_example(i)
            pts, valid = ex.image_coords.copy(), ex.joint_validity.copy()
            for k in range(i % 4):
                j = (3 * i + k) % len(valid)
                pts[j], valid[j] = np.nan, False
            return dataclasses.replace(ex, image_coords=pts, joint_validity=valid)

    ds3, ds2 = JaxSynth(32), Gappy2D(32, two_d=True, seed=1)
    local = []  # [rank][step]
    for r in range(world):
        it = mixed_batch_iterator(cfg, ds3, ds2, n_occluders=N_OCC, host_id=r, host_count=world)
        local.append([next(it) for _ in range(STEPS)])
        it.close()
        for k, b in enumerate(local[r]):
            np.savez(os.path.join(outdir, f"batch{k}_rank{r}.npz"), **b)
    glob = [{key: np.concatenate([local[r][k][key] for r in range(world)]) for key in local[0][k]}
            for k in range(STEPS)]
    valid = [[float((b["joint_validity"] * b["is_3d"][:, None]).sum()),
              float(b["joint_validity_2d"].sum())] for b in (local[r][0] for r in range(world))]
    tx = jloop.make_optimizer(cfg)
    start = jax.device_get(jax.jit(lambda key: jax_create_train_state(cfg, tx, key))(
        jax.random.PRNGKey(3)))
    init = train_state_from_flax(start)
    torch.save({"state": init}, os.path.join(outdir, "setup.pt"))
    ref = {"valid_counts": valid}
    cases = {"plain": (TINY, None)}
    for case, (gs, rows) in GHOST_CASES[world].items():
        cases[case] = ({**TINY, "model.bn_group_size": str(gs)}, rows)
    for case, (over, rows) in cases.items():
        ccfg = apply_overrides(Config(), over)
        jstate = jax.tree_util.tree_map(jnp.array, start)
        jstep = jloop.make_train_step(ccfg, tx, occluder_bank=jnp.asarray(bank))
        jm = []
        for k in range(STEPS):
            b = {key: np.concatenate([local[r][k][key][:rows] for r in range(world)])
                 for key in local[0][k]}
            jstate, m = jstep(jstate, b)
            jm.append({k: float(v) for k, v in m.items()})
        want = state_dict_from_flax(jax.device_get({"params": jstate.params,
                                                    "batch_stats": jstate.batch_stats}))
        np.savez(os.path.join(outdir, f"jax_{case}.npz"), **_flat_dict(want))
        ref[f"jax_{case}"] = jm
    port = create_train_state(cfg, "cpu")
    port.load_state_dict(init)
    step = make_train_step(cfg, 0, occluder_bank=pack_occluder_bank_for(bank, "cpu"))
    ref["one_plain"] = [{k: float(v) for k, v in step(port, batch_to_device(b, "cpu")).items()}
                        for b in glob]
    np.savez(os.path.join(outdir, "one_plain.npz"), **_flat_dict(port.model.state_dict()))
    with open(os.path.join(outdir, "reference.json"), "w") as f:
        json.dump(ref, f)
    _spawn("steps", world, outdir)


def _steps_run(tmp_path_factory, world: int) -> dict:
    outdir = _once(tmp_path_factory, f"parallel_steps{world}",
                   lambda d: _produce_steps(world, d))
    with open(os.path.join(outdir, "reference.json")) as f:
        ref = json.load(f)
    ranks = [torch.load(os.path.join(outdir, f"plain_rank{r}.pt"), weights_only=True)
             for r in range(world)]
    outs = []
    for r in range(world):
        with open(os.path.join(outdir, f"steps_rank{r}.json")) as f:
            outs.append(json.load(f))
    return {"world": world, "dir": outdir, "ref": ref, "ranks": ranks, "outs": outs}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"{w}ranks")
def steps(request, tmp_path_factory):
    return _steps_run(tmp_path_factory, request.param)


@pytest.fixture(scope="module")
def steps2(tmp_path_factory):
    return _steps_run(tmp_path_factory, 2)


def _check_against_jax(got_metrics, got_model: dict, want_metrics, want: dict, lr: float):
    """`test_torch_train.test_train_steps_match_jax`'s float32 tolerances."""
    for i, (pm, jm) in enumerate(zip(got_metrics, want_metrics)):
        assert set(pm) == set(jm)
        for key in jm:
            rtol = 1e-2 if key == "grad_norm" else 2e-4
            assert pm[key] == pytest.approx(jm[key], rel=rtol), (i, key)
    got = _flat_dict(got_model)
    assert set(got) == set(want)
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    params = sorted(k for k in want if k not in stats)
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3, err_msg=k)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in params])
    assert diff.max() <= 2 * lr * STEPS + 1e-6
    assert (diff <= 0.1 * lr).mean() > 0.99


def test_ranks_hold_different_valid_joint_counts(steps):
    counts = steps["ref"]["valid_counts"]
    assert len({c[0] for c in counts}) > 1 or len({c[1] for c in counts}) > 1, counts
    assert all(c[1] > 0 for c in counts), counts  # every rank has valid 2D joints


def test_steps_match_jax_on_the_global_batch(steps):
    lr = _port_cfg(TINY).train.base_lr
    r0 = steps["ranks"][0]
    assert r0["step"] == STEPS
    want = dict(np.load(os.path.join(steps["dir"], "jax_plain.npz")))
    _check_against_jax(r0["metrics"], r0["model"], steps["ref"]["jax_plain"], want, lr)


def test_steps_match_one_process_on_the_global_batch(steps):
    r0 = steps["ranks"][0]
    for got, want in zip(r0["metrics"], steps["ref"]["one_plain"]):
        for key, rtol in SAME_RTOL.items():
            assert got[key] == pytest.approx(want[key], rel=rtol), key
    want = dict(np.load(os.path.join(steps["dir"], "one_plain.npz")))
    got = _flat_dict(r0["model"])
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    for k in stats:
        np.testing.assert_allclose(got[k], want[k], atol=SAME_STATS_ATOL, rtol=0, err_msg=k)
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in sorted(want)
                           if k not in stats])
    assert (diff > SAME_PARAM_ATOL).mean() < SAME_PARAM_OUTLIERS
    assert diff.max() <= SAME_PARAM_MAX_LR * _port_cfg(TINY).train.base_lr


def test_ranks_end_bit_for_bit_equal(steps):
    r0 = steps["ranks"][0]
    for r in steps["ranks"][1:]:
        assert r["metrics"] == r0["metrics"]
        assert r["model"].keys() == r0["model"].keys()
        for k, v in r0["model"].items():
            assert torch.equal(r["model"][k].view(torch.int32), v.view(torch.int32)), k
    for r, out in enumerate(steps["outs"]):
        assert out["index_count"] == [r, steps["world"]]


def test_second_initialization_is_a_no_op(steps):
    assert all(out["made"] and not out["again"] for out in steps["outs"])


def _check_ghost_case(run: dict, case: str):
    """The ranks' ghost-BN steps of `case` against the JAX package's on the
    global batch, and every rank's state bit for bit rank 0's."""
    lr = _port_cfg(TINY).train.base_lr
    ranks = [torch.load(os.path.join(run["dir"], f"{case}_rank{r}.pt"), weights_only=True)
             for r in range(run["world"])]
    want = dict(np.load(os.path.join(run["dir"], f"jax_{case}.npz")))
    _check_against_jax(ranks[0]["metrics"], ranks[0]["model"], run["ref"][f"jax_{case}"],
                       want, lr)
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for k, v in ranks[0]["model"].items():
            assert torch.equal(r["model"][k], v), k


def test_ghost_bn_matches_jax(steps2):
    """Groups of 4 rows, half of each rank's 8, against the JAX package's
    ghost BN over the global batch of 16."""
    _check_ghost_case(steps2, "ghost")


@pytest.mark.parametrize("world,case", ACROSS_RANKS, ids=ACROSS_IDS)
def test_ghost_groups_across_ranks_match_jax(tmp_path_factory, world, case):
    """Groups that take rows of several ranks: twice the local batch
    ("span"), or a boundary inside a group ("straddle": 6 + 6 rows in
    groups of 4 at 2 ranks, 3 a rank at 4), against JAX's ghost BN over
    the same global batch."""
    _check_ghost_case(_steps_run(tmp_path_factory, world), case)


def test_ghost_group_size_not_dividing_the_global_batch_raises(steps):
    for out in steps["outs"]:
        assert out["indivisible_error"] == (
            f"batch 16 not divisible by bn group size {INDIVISIBLE_GS}"), out["indivisible_error"]


def test_rank_batch_guard_raises(steps):
    w = steps["world"]
    for r, out in enumerate(steps["outs"]):
        assert out["guard_error"] == f"global batch {4 * w + 1} not divisible by {w} processes"
        assert out["slice"] == [8, 8 * r]


# --- the trainer and predict: train(), resume, the logdir, the dumps ------------


def _produce_trainer(outdir: str) -> None:
    import dataclasses

    from metro_pose3d_tpu_torch.evaluation.predict import predict_dataset
    from metro_pose3d_tpu_torch.init import init_metro_model
    from metro_pose3d_tpu_torch.main import _load_model

    _spawn("trainer", 2, outdir, torchrun_env=True)
    cfg = _port_cfg(TRAIN_RUN)
    ds = _trainer_dataset()
    one = predict_dataset(cfg, init_metro_model(cfg.model, 0, "cpu"), ds)
    np.savez(os.path.join(outdir, "pred_one.npz"), **one)
    # one process's dump of the uninterrupted run's weights
    whole = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, logdir=os.path.join(outdir, "whole")))
    np.savez(os.path.join(outdir, "pred_whole_one.npz"),
             **predict_dataset(whole, _load_model(whole, ds, "cpu"), ds))


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    outdir = _once(tmp_path_factory, "parallel_trainer", _produce_trainer)
    outs = []
    for r in range(2):
        with open(os.path.join(outdir, f"trainer_rank{r}.json")) as f:
            outs.append(json.load(f))
    return {"dir": outdir, "outs": outs}


def _state(trainer, name: str, rank: int) -> dict:
    return torch.load(os.path.join(trainer["dir"], f"{name}_rank{rank}.pt"), weights_only=True)


def test_trainer_ranks_end_equal(trainer):
    for out in trainer["outs"]:
        assert (out["cut_step"], out["resumed_step"], out["whole_step"]) == (CUT_AT, 10, 10)
        assert (out["whole_rc"], out["test_rc"]) == (0, 0)
    for name in ("resumed", "whole"):
        a, b = _state(trainer, name, 0), _state(trainer, name, 1)
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)


def test_trainer_resumed_run_equals_uninterrupted_run(trainer):
    a, b = _state(trainer, "resumed", 0), _state(trainer, "whole", 0)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with open(os.path.join(trainer["dir"], "cut", "history.json")) as f:
        resumed = json.load(f)
    with open(os.path.join(trainer["dir"], "whole", "history.json")) as f:
        whole = json.load(f)
    assert [r["step"] for r in resumed] == [r["step"] for r in whole]
    assert [r["step"] for r in whole if "val_mpjpe" in r] == [3, 6, 9]
    for x, y in zip(resumed, whole):
        for key in ("loss", "grad_norm", "val_mpjpe"):
            assert x.get(key) == y.get(key), (x["step"], key)


def test_main_joins_and_leaves_the_launchers_group(trainer):
    """`main --train` under torchrun's environment made the group it trained
    in (the resumed run equals it) and destroyed it on its way out."""
    for out in trainer["outs"]:
        assert out["whole_left_group"] is True


def test_trainer_rank0_alone_writes_the_logdir(trainer):
    """config.json, the history, the checkpoints, the best checkpoint and
    `main --test`'s dump are written by rank 0; rank 1 writes, renames and
    removes nothing."""
    writes0, writes1 = (out["writes"] for out in trainer["outs"])
    assert writes1 == []
    written = {os.path.relpath(p, trainer["dir"]) for event, p in writes0 if event == "open"}
    # a checkpoint is written into a temporary directory (by torch's own
    # writer, which this audit does not see) and renamed into place
    renamed = [os.path.relpath(p, trainer["dir"]) for event, p in writes0 if event == "os.rename"]
    for logdir in ("cut", "whole"):
        for name in ("config.json", "history.json", "history.jsonl"):
            assert os.path.join(logdir, name) in written, (logdir, name, sorted(written))
        for slot in ("checkpoints", "best"):
            assert any(p.startswith(os.path.join(logdir, slot, ".tmp-")) for p in renamed), (
                slot, renamed)
    assert os.path.join("whole", "predictions.npz") in written, sorted(written)
    steps = sorted(int(n) for n in os.listdir(os.path.join(trainer["dir"], "cut", "checkpoints"))
                   if n.isdigit())
    assert CUT_AT in steps and steps[-1] == 10, steps


def _assert_same_dump(got: dict, one: dict):
    for key in ("pose3d_rootrel", "pose3d_abs", "pose2d_px", "gt3d_rootrel", "gt3d_abs",
                "valid"):
        assert got[key].shape == one[key].shape, key
        if key.startswith(("gt", "valid")):
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)
        else:
            # the same model on the same crops, in batches of other sizes
            np.testing.assert_allclose(got[key], one[key], rtol=1e-5, atol=1e-3, err_msg=key)


def test_predict_blocks_concatenate_to_one_process_dump(trainer):
    one = dict(np.load(os.path.join(trainer["dir"], "pred_one.npz")))
    blocks = [dict(np.load(os.path.join(trainer["dir"], f"pred_rank{r}.npz"))) for r in range(2)]
    assert [int(b["example_offset"]) for b in blocks] == [0, -(-N_TEST // 2)]
    _assert_same_dump({k: np.concatenate([b[k] for b in blocks]) for k in blocks[0]
                       if k not in ("joint_names", "example_offset")}, one)


def test_main_test_on_two_ranks_writes_the_one_process_dump(trainer):
    """`main --test` under a group: each rank predicts its block, and rank
    0 writes the blocks gathered in rank order, which is the dump one
    process makes of the same weights."""
    got = dict(np.load(os.path.join(trainer["dir"], "whole", "predictions.npz")))
    one = dict(np.load(os.path.join(trainer["dir"], "pred_whole_one.npz")))
    assert got.keys() == one.keys()
    assert int(got["example_offset"]) == 0 and len(got["gt3d_abs"]) == N_TEST
    np.testing.assert_array_equal(got["joint_names"], one["joint_names"])
    _assert_same_dump(got, one)


def test_replicated_validation_agrees_across_ranks(trainer):
    vals = [out["val_mpjpe"] for out in trainer["outs"]]
    assert np.isfinite(vals[0]) and vals[0] == vals[1]


# --- initialization, in this process -----------------------------------------


_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.mark.parametrize("world_size", [None, "1"])
def test_initialize_without_a_world_is_a_no_op(monkeypatch, world_size):
    from metro_pose3d_tpu_torch.parallel.distributed import (
        initialize_distributed, process_index_count,
    )

    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    if world_size is not None:
        monkeypatch.setenv("WORLD_SIZE", world_size)
    assert initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert process_index_count() == (0, 1)


def test_initialize_a_world_without_rank_raises(monkeypatch):
    from metro_pose3d_tpu_torch.parallel.distributed import initialize_distributed

    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="needs RANK"):
        initialize_distributed(device="cpu")
    assert not torch.distributed.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("how", ["file", "env"])
def test_unreachable_rendezvous_raises_within_its_timeout(monkeypatch, tmp_path, how):
    """Rank 1 of 2 whose rank 0 never comes: a `file://` rendezvous that no
    one else joins, or torchrun's environment naming a port where nothing
    listens."""
    from metro_pose3d_tpu_torch.parallel.distributed import initialize_distributed

    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    timeout = 2.0
    t0 = time.monotonic()
    with pytest.raises(Exception):  # noqa: B017 (torch raises RuntimeError or DistNetworkError)
        if how == "file":
            initialize_distributed(1, 2, init_method=f"file://{tmp_path / 'rdv'}",
                                   backend="gloo", timeout=timeout, device="cpu")
        else:
            monkeypatch.setenv("RANK", "1")
            monkeypatch.setenv("WORLD_SIZE", "2")
            monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
            monkeypatch.setenv("MASTER_PORT", str(_free_port()))
            initialize_distributed(timeout=timeout, device="cpu")
    # the store's connect retries once more after the timeout
    assert time.monotonic() - t0 < 4 * timeout + 5
    assert not torch.distributed.is_initialized()


def test_global_batch_guards_raise():
    from metro_pose3d_tpu.config import Config, apply_overrides

    from metro_pose3d_tpu_torch.parallel.distributed import local_batch_slice
    from metro_pose3d_tpu_torch.train.trainer import mixed_batch_iterator
    from test_torch_pipeline import JaxSynth

    assert local_batch_slice(16) == (16, 0)  # one process here
    assert local_batch_slice(16, 3, 4) == (4, 12)
    with pytest.raises(ValueError, match="global batch 10 not divisible by 4 processes"):
        local_batch_slice(10, 0, 4)
    cfg = apply_overrides(Config(), TINY)
    with pytest.raises(ValueError, match="global batch 8 not divisible by 3 processes"):
        next(mixed_batch_iterator(cfg, JaxSynth(8), host_id=0, host_count=3))
    cfg2 = apply_overrides(Config(), {**TINY, "train.batch_size": "6", "train.batch_size_2d": "4"})
    with pytest.raises(ValueError, match="global batch 4 not divisible by 3 processes"):
        next(mixed_batch_iterator(cfg2, JaxSynth(8), JaxSynth(8, two_d=True),
                                  host_id=1, host_count=3))


def test_loading_a_train_state_leaves_its_source_as_it_was():
    """Both cases of a spawn start from one loaded dict: an update of the
    first state must not reach the second through Adam's moments."""
    from metro_pose3d_tpu_torch.train.state import create_train_state

    cfg = _port_cfg(TINY)
    src = create_train_state(cfg, "cpu", seed=1)
    for p in src.model.parameters():
        p.grad = torch.ones_like(p)
    src.optimizer.step()
    d = src.state_dict()
    before = {n: {k: v.clone() for k, v in s.items()} for n, s in d["adam"].items()}
    state = create_train_state(cfg, "cpu", seed=2)
    state.load_state_dict(d)
    for p in state.model.parameters():
        p.grad = torch.full_like(p, -3.0)
    state.optimizer.step()
    for n, s in d["adam"].items():
        for k, v in s.items():
            assert torch.equal(v, before[n][k]), (n, k)


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
