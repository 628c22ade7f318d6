"""The port's command line (`metro_pose3d_tpu_torch/main.py`), its config
parser, export bundle, metric writer and in-loop validation, against the
JAX package's on the CPU.

Every case of `tests/test_cli.py` runs through the port's
`main(..., device="cpu")`. Where a mode predicts, both packages run on the
same weights: JAX's `main` without a checkpoint takes its seeded init
(`create_train_state`, PRNGKey(train.seed)), and the port's `main` restores
that init, converted (`convert.train_state_from_flax`) and saved as the
port's checkpoint. Float32 dumps hold to JAX's at
`tests/test_torch_protocol.py::ATOL`; int8 scores at that file's int8 rtol
of 1e-3 (float32 roundoff moves a few values across int8 rounding edges).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from metro_pose3d_tpu import main as jax_main_mod
from metro_pose3d_tpu.config import parse_cli as jax_parse_cli
from metro_pose3d_tpu.data import synth_shard
from metro_pose3d_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from metro_pose3d_tpu.evaluation import eval_3dpw as jax_eval_3dpw
from metro_pose3d_tpu.evaluation import eval_h36m as jax_eval_h36m
from metro_pose3d_tpu.parallel.mesh import make_mesh
from metro_pose3d_tpu.train.loop import make_optimizer as jax_make_optimizer
from metro_pose3d_tpu.train.state import create_train_state as jax_create_train_state
from metro_pose3d_tpu.train.trainer import validate as jax_validate
from metro_pose3d_tpu.utils import writers as jax_writers
from metro_pose3d_tpu_torch import main as main_mod
from metro_pose3d_tpu_torch.config import Config, apply_overrides, parse_cli
from metro_pose3d_tpu_torch.convert import load_flax_variables, train_state_from_flax
from metro_pose3d_tpu_torch.data.synthetic import SyntheticDataset
from metro_pose3d_tpu_torch.evaluation import eval_3dpw, eval_h36m
from metro_pose3d_tpu_torch.export import load_exported
from metro_pose3d_tpu_torch.models.metro import MetroModel
from metro_pose3d_tpu_torch.train.checkpoint import Checkpointer
from metro_pose3d_tpu_torch.train.state import create_train_state
from metro_pose3d_tpu_torch.train.trainer import validate
from metro_pose3d_tpu_torch.utils import writers

TINY = ["--model.backbone=tiny", "--model.proc_side=64", "--model.depth=4",
        "--model.compute_dtype=float32", "--data.source_side=128"]
# tests/test_torch_protocol.py's float32 tolerances
ATOL = {"pose3d_rootrel": 5e-3, "pose2d_px": 1e-4, "pose3d_abs": 0.25}
INT8_RTOL = 1e-3


def main(argv):
    return main_mod.main(argv, device="cpu")


def _jax_init_as_port_checkpoint(args, logdir):
    """Save JAX's seeded init for the config of `args` (quantize none, as
    both packages restore) as the port's checkpoint of step 1 in `logdir`."""
    jcfg, _ = jax_parse_cli(args + ["--model.quantize=none"])
    jstate = jax_create_train_state(jcfg, jax_make_optimizer(jcfg))
    cfg, _ = parse_cli(args + ["--model.quantize=none"])
    state = create_train_state(cfg, "cpu")
    state.load_state_dict(train_state_from_flax(jax.device_get(jstate)))
    Checkpointer(logdir).save(1, state)


def _both(args, tmp_path, capsys=None):
    """Run JAX's main and the port's on `args` (weights as the module doc
    says), each with its own logdir and pred_path. -> (port, JAX) of
    (rc, pred_path, stdout)."""
    out = []
    for who, run in (("port", main), ("jax", jax_main_mod.main)):
        logdir, pred = str(tmp_path / who), str(tmp_path / f"{who}.npz")
        if who == "port":
            _jax_init_as_port_checkpoint(args, logdir)
        rc = run(args + [f"--train.logdir={logdir}", f"--eval.pred_path={pred}"])
        out.append((rc, pred, capsys.readouterr().out if capsys else None))
    return out


def _json_tail(stdout):
    """The JSON object a scorer or table printed last."""
    return json.loads(stdout[stdout.index("{"):])


def test_no_mode_prints_usage_and_fails(capsys):
    assert main([]) == 1
    assert "python -m metro_pose3d_tpu_torch.main --train" in capsys.readouterr().out
    assert jax_main_mod.main([]) == 1


def _eval_dump(mode, rng):
    if mode == "--eval-3dpw":
        gt = rng.normal(0, 200, (6, 24, 3)).astype(np.float32)
        return {"pose3d": gt + 3, "gt3d": gt, "seq": np.array(["s"] * 6)}
    gt = rng.normal(0, 200, (12, 17, 3)).astype(np.float32)
    return {"pose3d_rootrel": gt + rng.normal(0, 5, gt.shape).astype(np.float32),
            "gt3d_rootrel": gt, "actions": np.array(["Walking", "Photo", "Sitting"] * 4)}


@pytest.mark.parametrize("mode", ["--eval-h36m", "--eval-3dhp", "--eval-3dpw"])
def test_eval_modes_print_jax_scores(mode, tmp_path, capsys):
    path = tmp_path / "p.npz"
    np.savez(path, **_eval_dump(mode, np.random.default_rng(len(mode))))
    assert main([mode, f"--eval.pred_path={path}"]) == 0
    got = _json_tail(capsys.readouterr().out)
    assert jax_main_mod.main([mode, f"--eval.pred_path={path}"]) == 0
    assert got == _json_tail(capsys.readouterr().out)
    if mode == "--eval-h36m":
        assert 5 < got["mpjpe"] < 15
    if mode == "--eval-3dpw":
        assert abs(got["mpjpe"] - np.sqrt(27)) < 0.1


TEST_ARGS = ["--test", "--data.dataset=synthetic", "--data.synthetic_n_test=16", *TINY,
             "--eval.batch_size=8", "--eval.flip_tta=false"]


def test_test_mode_matches_jax(tmp_path):
    """--test on the synthetic dataset: the two-phase predict -> dump flow,
    the dump row for row against JAX's, then scored."""
    (rc, pred, _), (rc_j, pred_j, _) = _both(TEST_ARGS, tmp_path)
    assert rc == rc_j == 0
    got, want = np.load(pred), np.load(pred_j)
    assert set(got.files) == set(want.files)
    for key in got.files:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
        if key in ATOL:
            np.testing.assert_allclose(got[key], want[key], atol=ATOL[key], rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["pose3d_rootrel"].shape == (16, 17, 3)
    assert main(["--eval-h36m", f"--eval.pred_path={pred}"]) == 0


def test_test_mode_int8_calibrates(tmp_path):
    """--test with model.quantize=int8 calibrates in `_load_model` (the
    checkpoint carries no int8 scales); its MPJPE holds to JAX's."""
    (rc, pred, _), (rc_j, pred_j, _) = _both(TEST_ARGS + ["--model.quantize=int8"], tmp_path)
    assert rc == rc_j == 0
    got = np.load(pred)
    assert np.isfinite(got["pose3d_rootrel"]).all()
    np.testing.assert_allclose(eval_h36m.evaluate(pred)["mpjpe"],
                               jax_eval_h36m.evaluate(pred_j)["mpjpe"], rtol=INT8_RTOL)


def test_int8_without_a_dataset_raises(tmp_path):
    cfg, _ = parse_cli(TINY + ["--model.quantize=int8", f"--train.logdir={tmp_path}"])
    with pytest.raises(ValueError, match="calibration data"):
        main_mod._load_model(cfg, None, device="cpu")


def test_multiperson_int8_end_to_end(tmp_path):
    """--test-multiperson with model.quantize=int8 on the synthetic 3DPW
    release: calibration off the dataset's crops, the int8 model through
    the frame path, TTA and the reconstruction, then --eval-3dpw; the scores
    hold to JAX's."""
    root = tmp_path / "release"
    synth_shard.write_synthetic_3dpw_release(str(root))
    args = ["--test-multiperson", "--data.dataset=3dpw", f"--data.data_root={root}",
            "--model.num_joints=24", "--model.backbone=tiny", "--model.proc_side=128",
            "--model.depth=4", "--model.compute_dtype=float32", "--model.quantize=int8"]
    (rc, pred, _), (rc_j, pred_j, _) = _both(args, tmp_path)
    assert rc == rc_j == 0
    got = np.load(pred, allow_pickle=True)
    assert np.isfinite(got["pose3d_abs"]).all() and got["pose3d_abs"].shape == (10, 24, 3)
    np.testing.assert_array_equal(got["seq"], np.load(pred_j, allow_pickle=True)["seq"])
    scores, want = eval_3dpw.evaluate_3dpw(pred), jax_eval_3dpw.evaluate_3dpw(pred_j)
    for key in ("mpjpe", "pa_mpjpe"):
        np.testing.assert_allclose(scores[key], want[key], rtol=INT8_RTOL, err_msg=key)
    assert main(["--eval-3dpw", f"--eval.pred_path={pred}"]) == 0


def test_export_int8_calibrates_and_bundles(tmp_path):
    """--export with model.quantize=int8: calibrated scales in the bundle,
    JAX's config layout (JAX reads the port's config back), a reload on the
    CPU and a prediction."""
    out = tmp_path / "bundle"
    args = [f"--export={out}", "--data.dataset=synthetic", "--data.synthetic_n_test=16",
            *TINY, "--model.quantize=int8", "--eval.batch_size=8"]
    args += [f"--train.logdir={tmp_path / 'log'}"]
    _jax_init_as_port_checkpoint(args, str(tmp_path / "log"))
    assert main(args) == 0
    cfg2, model, fn = load_exported(str(out), device="cpu")
    assert cfg2 == parse_cli(args)[0] and cfg2.model.quantize == "int8"
    amax = [float(v) for k, v in model.state_dict().items() if k.endswith(".amax")]
    assert amax and all(a > 0 for a in amax)
    crops = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3))
                             .astype(np.uint8))
    intr = torch.tensor([[90.0, 0, 31.5], [0, 90.0, 31.5], [0, 0, 1]]).expand(2, 3, 3)
    res = fn(model, crops, intr)
    assert res["pose3d_rootrel"].shape == (2, 17, 3)
    assert torch.isfinite(res["pose3d_rootrel"]).all()
    # the JAX package's load_exported reads this layout: the same config
    with open(out / "config.json") as f:
        meta = json.load(f)
    assert meta["joint_info"] == "h36m_17"
    flat = {f"{s}.{n}": str(v) for s, fields in meta["config"].items() for n, v in fields.items()}
    jcfg = jax_parse_cli([f"--{k}={v}" for k, v in flat.items()])[0]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg2)


def test_matmul_precision_flag_turns_tf32_off(tmp_path):
    """model.matmul_precision=highest reaches torch's process-wide flags."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    path = tmp_path / "p.npz"
    np.savez(path, **_eval_dump("--eval-h36m", np.random.default_rng(0)))
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        assert main(["--eval-h36m", f"--eval.pred_path={path}",
                     "--model.matmul_precision=highest"]) == 0
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def test_eval_truncation_mode_matches_jax(tmp_path, capsys):
    args = ["--eval-truncation", "--data.dataset=synthetic", "--data.synthetic_n_test=6", *TINY]
    (rc, _, out), (rc_j, _, out_j) = _both(args, tmp_path, capsys)
    assert rc == rc_j == 0
    got, want = _json_tail(out), _json_tail(out_j)
    assert list(got) == list(want) == ["0.0", "0.1", "0.2", "0.3", "0.4", "0.5"]
    for frac, row in want.items():
        assert set(got[frac]) == set(row)
        for key, val in row.items():
            np.testing.assert_allclose(got[frac][key], val, atol=1e-3, rtol=0,
                                       err_msg=f"{frac} {key}")


# --- the config parser ---------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    [],
    ["--train", "--model.depth=8", "--eval.flip_tta=false"],
    ["--export=/tmp/b", "--data.source_side=256", "--train.base_lr=3e-4", "extra"],
    ["--test", "--model.quantize=int8", "--model.quantize_calib=absmax", "--x=1"],
    ["--data.dataset=3dpw", "--data.data_root=/d/x.y", "--train.logdir=/a=b/c"],
], ids=["empty", "modes_and_flags", "export_and_floats", "int8", "values_with_dots"])
def test_parse_cli_matches_jax(argv):
    cfg, rest = parse_cli(argv)
    jcfg, jrest = jax_parse_cli(argv)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert rest == jrest


def test_parse_cli_refuses_an_unknown_field():
    with pytest.raises(ValueError, match="unknown config field model.nope"):
        parse_cli(["--model.nope=1"])


# --- the metric writer ------------------------------------------------------------------

def test_history_rows_have_the_jax_layout(tmp_path):
    scalars = [(1, {"loss": np.float32(0.25), "grad_norm": 1.5, "crops_per_sec": 10}),
               (4, {"val_mpjpe": np.float64(123.456)})]
    for who, mod in (("port", writers), ("jax", jax_writers)):
        w = mod.MetricWriter(str(tmp_path / who), use_tensorboard=False)
        for step, row in scalars:
            w.write_scalars(step, row)
        w.close()
    got = (tmp_path / "port" / "history.jsonl").read_text()
    assert got == (tmp_path / "jax" / "history.jsonl").read_text()
    assert [json.loads(line)["step"] for line in got.splitlines()] == [1, 4]
    null = writers.make_metric_writer(str(tmp_path / "null"), primary=False)
    null.write_scalars(1, {"loss": 1.0})
    null.close()
    assert isinstance(null, writers.NullWriter) and not (tmp_path / "null").exists()


# --- in-loop validation -----------------------------------------------------------------

def test_validate_matches_jax():
    cfg, _ = parse_cli(TINY + ["--eval.batch_size=8"])
    jcfg, _ = jax_parse_cli(TINY + ["--eval.batch_size=8"])
    jstate = jax_create_train_state(jcfg, jax_make_optimizer(jcfg))
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    model = load_flax_variables(MetroModel(cfg.model), variables).train()
    want = jax_validate(jcfg, variables, JaxSynthetic(n_test=20), make_mesh(), n_batches=2)
    got = validate(cfg, model, SyntheticDataset(n_test=20), n_batches=2)
    assert model.training  # validation ran in eval mode and gave the mode back
    np.testing.assert_allclose(got, want, atol=ATOL["pose3d_rootrel"], rtol=0)


TRAIN_ARGS = ["--train", "--data.dataset=synthetic", "--data.synthetic_n_train=64",
              "--data.synthetic_n_test=8", *TINY, "--train.batch_size=8",
              "--train.batch_size_2d=0", "--train.validate_every=2",
              "--train.validate_batches=1", "--eval.batch_size=8", "--train.log_every=2",
              "--train.checkpoint_every=2", "--train.warmup_steps=0", "--train.base_lr=1e-2"]


def test_train_mode_validates_and_keeps_the_best(tmp_path):
    """--train with train.validate_every=2: a val_mpjpe row every 2 steps in
    history.jsonl and history.json, the best checkpoint at their minimum,
    and a resume from step 4 to 8 that keeps the rows before it and the best
    checkpoint of both legs."""
    logdir = tmp_path / "run"
    args = TRAIN_ARGS + [f"--train.logdir={logdir}"]
    assert main(args + ["--train.num_steps=4"]) == 0

    def val_rows():
        rows = [json.loads(line) for line in (logdir / "history.jsonl").read_text().splitlines()]
        return [r for r in rows if "val_mpjpe" in r]

    def best():
        ckpt = Checkpointer(str(logdir))
        state, step = ckpt.restore_best(create_train_state(parse_cli(args)[0], "cpu"))
        return step, ckpt.best_metric(), state

    first = val_rows()
    assert [r["step"] for r in first] == [2, 4]
    assert all(set(r) == {"step", "val_mpjpe"} and np.isfinite(r["val_mpjpe"]) for r in first)
    step, metric, state = best()
    low = min(first, key=lambda r: r["val_mpjpe"])
    assert (step, metric, state.step) == (low["step"], low["val_mpjpe"], low["step"])

    assert main(args + ["--train.num_steps=8"]) == 0  # resumes from step 4
    rows = val_rows()
    assert [r["step"] for r in rows] == [2, 4, 6, 8] and rows[:2] == first
    hist = json.load(open(logdir / "history.json"))
    assert [r["step"] for r in hist if "val_mpjpe" in r] == [2, 4, 6, 8]
    assert [r["step"] for r in hist if "loss" in r] == [2, 4, 6, 8]
    step, metric, _ = best()
    low = min(rows, key=lambda r: r["val_mpjpe"])
    assert (step, metric) == (low["step"], low["val_mpjpe"])
    assert sorted(os.listdir(logdir / "best")) == [str(step), "best_metric.txt"]


def test_validation_runs_the_test_stride(tmp_path, monkeypatch):
    """With stride_train != stride_test the weights are validated by a
    model built at the test stride, loaded with the current weights."""
    from metro_pose3d_tpu_torch.train import trainer

    seen = []
    real = trainer.validate

    def spy(cfg, model, dataset, **kw):
        seen.append((model.cfg.stride, model.training))
        return real(cfg, model, dataset, **kw)

    monkeypatch.setattr(trainer, "validate", spy)
    cfg = apply_overrides(parse_cli(TRAIN_ARGS)[0], {
        "model.stride_train": "32", "model.stride_test": "16", "train.num_steps": "2",
        "train.logdir": str(tmp_path)})
    state = trainer.train(cfg, SyntheticDataset(n_train=16, n_test=8), device="cpu")
    assert seen == [(16, False)] and state.model.cfg.stride == 32
