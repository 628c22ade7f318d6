"""The port's training path against the JAX package on the CPU.

Train steps from one state: a JAX `create_train_state` converted with
`convert.train_state_from_flax`, on batches from the JAX host loader over
`SyntheticDataset`, through both packages' train steps; the metrics, the
per-tensor gradients, the BN statistics and the parameters must agree.
Also: float32 master parameters under bf16, checkpoints, the batch-fed
loop (`trainer._train_on_batches`) with a resume against an uninterrupted
run, and `train()` from datasets through the port's host pipeline: the
batches its step sees against the JAX package's `mixed_batch_iterator`, a
resume that prepares no skipped example, and the background bank decided by
`dataset.has_masks`.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metro_pose3d_tpu.config import Config, apply_overrides
from metro_pose3d_tpu.data.synthetic import SyntheticDataset
from metro_pose3d_tpu.models.losses import compute_losses as jax_compute_losses
from metro_pose3d_tpu.models.metro import MetroModel as FlaxMetro
from metro_pose3d_tpu.pipeline.backgrounds import (
    make_procedural_backgrounds as jax_make_procedural_backgrounds,
)
from metro_pose3d_tpu.pipeline.device import device_augment as jax_device_augment
from metro_pose3d_tpu.pipeline.loader import prepare_one, stack_examples
from metro_pose3d_tpu.pipeline.occluders import make_procedural_occluders
from metro_pose3d_tpu.train import loop as jloop
from metro_pose3d_tpu.train.state import create_train_state as jax_create_train_state
from metro_pose3d_tpu_torch.convert import state_dict_from_flax, train_state_from_flax
from metro_pose3d_tpu_torch.models.losses import compute_losses
from metro_pose3d_tpu_torch.models.metro import MetroModel
from metro_pose3d_tpu_torch.pipeline import device as device_mod
from metro_pose3d_tpu_torch.pipeline.backgrounds import make_procedural_backgrounds
from metro_pose3d_tpu_torch.pipeline.device import (
    batch_to_device, device_augment, pack_occluder_bank_for,
)
from metro_pose3d_tpu_torch.train import checkpoint as ckpt_mod
from metro_pose3d_tpu_torch.train.checkpoint import Checkpointer
from metro_pose3d_tpu_torch.train.loop import make_train_step
from metro_pose3d_tpu_torch.train.state import create_train_state
from metro_pose3d_tpu_torch.train import trainer as trainer_mod
from metro_pose3d_tpu_torch.train.trainer import _train_on_batches, train
from test_torch_pipeline import JaxSynth

TINY = {
    "model.backbone": "tiny",
    "model.proc_side": "64",
    "model.depth": "4",
    "model.compute_dtype": "float32",
    "train.batch_size": "8",
    "train.batch_size_2d": "0",
    "train.warmup_steps": "0",
    "train.validate_every": "0",
    "data.source_side": "128",
}
N_OCC = 64


def _cfg(**over):
    return apply_overrides(Config(), {**TINY, **over})


@pytest.fixture(scope="module")
def host_batches():
    """Eight host batches of 8 from the JAX loader's example prep."""
    ds = SyntheticDataset(n_train=64, n_test=8, imshape=(256, 256))
    cfg = _cfg()
    out = []
    for k in range(8):
        prepared = [prepare_one(ds.train_example(8 * k + i), ds.joint_info, 64, 128, cfg.aug,
                                (0, 0, 8 * k + i), N_OCC) for i in range(8)]
        out.append(stack_examples(prepared))
    return out


@pytest.fixture(scope="module")
def bank():
    return make_procedural_occluders(N_OCC, 96)


def _mixed(batch):
    """Rows 5..7 as 2D-only examples: no 3D supervision."""
    b = {k: v.copy() for k, v in batch.items()}
    b["is_3d"][5:] = 0.0
    b["joint_validity"][5:] = 0.0
    return b


def _masked(batch, seed=9):
    """The batch with a random foreground mask and background parameters
    (enabled 0/1, bank index 0..2), and a bank of 3 random backgrounds."""
    b = dict(batch)
    rng = np.random.RandomState(seed)
    b["source_mask"] = rng.randint(0, 256, (8, 128, 128)).astype(np.uint8)
    b["bg_params"] = np.stack([rng.randint(0, 2, 8), rng.randint(0, 3, 8)],
                              1).astype(np.float32)
    return b, rng.randint(0, 256, (3, 128, 128, 3)).astype(np.uint8)


@pytest.mark.parametrize("n,side,seed", [(3, 32, 1), (2, 48, 7)])
def test_procedural_backgrounds_match_jax(n, side, seed):
    got = make_procedural_backgrounds(n, side, seed)
    assert got.dtype == np.uint8 and got.shape == (n, side, side, 3)
    np.testing.assert_array_equal(got, jax_make_procedural_backgrounds(n, side, seed))


def test_train_augment_matches_jax(host_batches, bank):
    batch, backgrounds = _masked(host_batches[0])
    want = np.asarray(jax.jit(lambda b, o, g: jax_device_augment(
        b, 64, o, train=True, background_bank=g))(
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(bank),
        jnp.asarray(backgrounds)))
    got = device_augment(batch_to_device(batch, "cpu"), 64, train=True,
                         occluder_bank=pack_occluder_bank_for(bank, "cpu"),
                         background_bank=torch.from_numpy(backgrounds)).numpy()
    assert np.any(batch["occ_params"][:, 0] == 1) and np.any(batch["color_params"][:, 0] != 0)
    assert np.any(batch["bg_params"][:, 0] == 1)
    # [-1, 1] units: the warp's 1e-2 in [0, 255] (test_torch_kernels_plain)
    # and the occluder placement's coordinate ulps
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


# name: (overrides, mixed 2D/3D batch, first batch, steps, masked batches
# with a background bank). The first batch of each float32 case keeps every
# ReLU input at least 2e-6 from 0 (see `_grads_on_same_crops`).
STEP_CASES = {
    "f32_ghost_bn_absloss_mixed": (
        {"model.bn_group_size": "4", "train.absloss_weight": "0.1"}, True, 5, 3, False),
    "f32": ({}, False, 0, 1, False),
    "bf16": ({"model.compute_dtype": "bfloat16"}, False, 0, 1, False),
    "f32_background": ({}, False, 0, 2, True),
}


@pytest.fixture(scope="module")
def jax_start():
    """The JAX package's initial train state, as numpy. Every step case has
    the same parameter tree and optimizer (the compute dtype and the BN
    grouping change neither), so one init serves them all."""
    cfg = _cfg()
    tx = jloop.make_optimizer(cfg)
    state = jax.jit(lambda key: jax_create_train_state(cfg, tx, key))(jax.random.PRNGKey(3))
    return jax.device_get(state)


def _grads_on_same_crops(cfg, jstate, port_model, batch, bank, backgrounds=None):
    """Per-tensor gradients of both packages' model + losses on the JAX
    package's augmented crops: the model's backward on equal inputs."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    crops = jax_device_augment(jb, cfg.model.proc_side, jnp.asarray(bank), train=True,
                               background_bank=None if backgrounds is None
                               else jnp.asarray(backgrounds))
    model = FlaxMetro(cfg.model.at_phase(train=True))

    def loss_fn(params):
        (l3d, l2d), _ = model.apply({"params": params, "batch_stats": jstate.batch_stats},
                                    crops, train=True, mutable=["batch_stats"])
        return jax_compute_losses(l3d, l2d, jb, cfg, 0)[0]

    want = state_dict_from_flax({"params": jax.jit(jax.grad(loss_fn))(jstate.params)})
    m = copy.deepcopy(port_model).train()  # its BN statistics stay untouched
    # A ReLU input within the two forwards' roundoff (~1e-6) of 0 may take
    # the other side in the other package and move its gradient entry; the
    # comparison holds to roundoff only on a batch that has none.
    # (each of these batch norms applies the ReLU itself, `act="relu"`: the
    # margin is read from its output before it)
    margins = []

    def record_margin(forward):
        def wrapped(x, act="none"):
            y = forward(x)
            margins.append(float(y.detach().abs().min()))
            return torch.nn.functional.relu(y) if act == "relu" else y
        return wrapped

    for name, mod in m.named_modules():
        if name.rsplit(".", 1)[-1] in ("bn_pre", "bn1", "bn2", "bn_final"):
            mod.forward = record_margin(mod.forward)
    l3d, l2d = m(torch.from_numpy(np.array(crops)))
    assert min(margins) >= 2e-6, f"a ReLU input {min(margins)} from 0: pick another batch"
    compute_losses(l3d, l2d, batch_to_device(batch, "cpu"), cfg, 0)[0].backward()
    return {n: p.grad for n, p in m.named_parameters()}, want


def _flat(named: dict) -> np.ndarray:
    return np.concatenate([np.asarray(named[k], np.float32).ravel() for k in sorted(named)])


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(case, host_batches, bank, jax_start):
    over, mixed, first, n_steps, masked = STEP_CASES[case]
    cfg = _cfg(**over)
    f32 = cfg.model.compute_dtype == "float32"
    batches = [_mixed(b) if mixed else b for b in host_batches[first:first + n_steps]]
    backgrounds = None
    if masked:
        pairs = [_masked(b, seed=9 + i) for i, b in enumerate(batches)]
        batches, backgrounds = [p[0] for p in pairs], pairs[0][1]
        assert all(np.any(b["bg_params"][:, 0] == 1) for b in batches)
    tx = jloop.make_optimizer(cfg)
    jstate = jax.tree_util.tree_map(jnp.array, jax_start)  # the step donates its input
    port = create_train_state(cfg, "cpu")
    port.load_state_dict(train_state_from_flax(jax_start))
    assert all(p.dtype == torch.float32 for p in port.model.parameters())
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    lr = cfg.train.base_lr

    if f32:
        got, want = _grads_on_same_crops(cfg, jstate, port.model, batches[0], bank,
                                         backgrounds)
        for name, w in want.items():
            # float32 roundoff through ~20 layers, per tensor against its norm
            # (head2d.bias has a zero gradient: the softmax ignores a shift)
            err = float((got[name] - w).norm())
            assert err <= 1e-4 * float(w.norm()) + 1e-7, (name, err, float(w.norm()))

    jstep = jloop.make_train_step(cfg, tx, occluder_bank=jnp.asarray(bank),
                                  background_bank=backgrounds)
    step = make_train_step(cfg, 0, occluder_bank=pack_occluder_bank_for(bank, "cpu"),
                           background_bank=None if backgrounds is None
                           else torch.from_numpy(backgrounds))
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, batch)
        pm = step(port, batch_to_device(batch, "cpu"))
        assert set(pm) == set(jm)
        for key in jm:
            # Through the whole step the crops differ by the warp's and the
            # occluder's roundoff (~1e-5), which can flip a ReLU whose input
            # is that close to 0 and move one gradient entry: grad_norm gets
            # 1e-2. bf16: the frameworks round at other places.
            rtol = (1e-2 if key == "grad_norm" else 2e-4) if f32 else 3e-2
            assert float(pm[key]) == pytest.approx(float(jm[key]), rel=rtol), (i, key)
    assert port.step == int(jstate.step) == n_steps

    got = port.model.state_dict()
    want = state_dict_from_flax(jax.device_get({"params": jstate.params,
                                                "batch_stats": jstate.batch_stats}))
    assert set(got) == set(want)
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    params = [k for k in want if k not in stats]
    for k in stats:
        # batch moments of the same forward, blended in with m = 0.99
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-4, rtol=1e-3,
                                   err_msg=k)
    assert all(got[k].dtype == torch.float32 for k in got)
    g, w = _flat({k: got[k] for k in params}), _flat({k: want[k] for k in params})
    moved = np.abs(g - _flat({k: before[k] for k in params}))
    # Adam moves each element by about lr per step. An element whose
    # gradient is near 0 may take the other sign in the other package, so
    # the bound is 2 lr per step; most elements agree to a tenth of lr.
    diff = np.abs(g - w)
    assert diff.max() <= 2 * lr * n_steps + 1e-6
    assert (diff <= 0.1 * lr).mean() > (0.99 if f32 else 0.9)
    assert 0.5 * lr < np.median(moved) <= lr * n_steps * 1.01
    if not f32:
        # the update is below bf16's resolution at these weights: bf16
        # master weights would have lost most of it
        p0 = torch.from_numpy(_flat({k: before[k] for k in params}))
        lost = (p0.bfloat16() == torch.from_numpy(g).bfloat16()).float().mean()
        assert float(lost) > 0.5


def test_bf16_model_keeps_float32_parameters_like_flax():
    cfg = _cfg(**{"model.compute_dtype": "bfloat16"})
    variables = jax.eval_shape(lambda: FlaxMetro(cfg.model).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=True))
    leaves = jax.tree_util.tree_leaves(variables)
    assert leaves and all(leaf.dtype == jnp.float32 for leaf in leaves)
    model = MetroModel(cfg.model, train=True)
    assert model.dtype == torch.bfloat16
    sd = model.state_dict()
    assert sd and all(v.dtype == torch.float32 for v in sd.values())
    assert len(list(model.parameters())) == len(jax.tree_util.tree_leaves(variables["params"]))
    x = torch.zeros(2, 64, 64, 3)
    l3d, l2d = model(x)  # computes in bf16, returns float32
    assert l3d.dtype == l2d.dtype == torch.float32


def _state_equal(a: dict, b: dict) -> bool:
    if a.keys() != b.keys():
        return False
    for k in a:
        if isinstance(a[k], dict):
            if not _state_equal(a[k], b[k]):
                return False
        elif isinstance(a[k], torch.Tensor):
            if not torch.equal(a[k], b[k]):
                return False
        elif a[k] != b[k]:
            return False
    return True


def _trained_state(host_batches, bank, steps=2):
    cfg = _cfg()
    state = create_train_state(cfg, "cpu", seed=1)
    step = make_train_step(cfg, 0, occluder_bank=pack_occluder_bank_for(bank, "cpu"))
    for b in host_batches[:steps]:
        step(state, batch_to_device(b, "cpu"))
    return cfg, state


def test_checkpoint_round_trip_keep_k_and_atomic_write(tmp_path, host_batches, bank,
                                                       monkeypatch):
    cfg, state = _trained_state(host_batches, bank)
    ck = Checkpointer(str(tmp_path), keep=3)
    assert ck.latest_step() is None
    fresh = create_train_state(cfg, "cpu", seed=2)
    assert ck.restore(fresh) == (fresh, 0)
    for s in range(1, 6):
        ck.save(s, state)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["3", "4", "5"]
    assert ck.latest_step() == 5

    restored, step = ck.restore(create_train_state(cfg, "cpu", seed=2))
    assert step == 5 and restored.step == state.step
    assert _state_equal(restored.state_dict(), state.state_dict())

    def broken_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", broken_save)
    with pytest.raises(OSError):
        ck.save(6, state)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["3", "4", "5"]  # nothing partial
    assert ck.latest_step() == 5


def test_checkpoint_best_slot(tmp_path, host_batches, bank):
    cfg, state = _trained_state(host_batches, bank, steps=1)
    ck = Checkpointer(str(tmp_path), keep=2)
    ck.save(1, state)
    other = create_train_state(cfg, "cpu", seed=5)
    restored, step = ck.restore_best(other)  # no best yet: the latest
    assert step == 1
    assert ck.save_if_best(10, state, 5.0)
    assert not ck.save_if_best(11, other, 6.0)
    assert ck.save_if_best(12, state, 4.0)
    for s in (13, 14, 15):
        ck.save(s, other)  # the rolling window cannot evict the best
    assert os.listdir(tmp_path / "best") and sorted(
        n for n in os.listdir(tmp_path / "best") if n.isdigit()) == ["12"]
    ck2 = Checkpointer(str(tmp_path), keep=2)
    assert ck2.best_metric() == 4.0
    restored, step = ck2.restore_best(create_train_state(cfg, "cpu", seed=5))
    assert step == 12
    assert _state_equal(restored.model.state_dict(), state.model.state_dict())


@pytest.mark.parametrize("cycle", [0, 3])
def test_train_resume_equals_uninterrupted_run(tmp_path, host_batches, bank, cycle):
    over = {"train.num_steps": "8", "train.log_every": "2", "train.checkpoint_every": "4",
            "data.cycle_batches": str(cycle)}
    cfg_a = _cfg(**over, **{"train.logdir": str(tmp_path / "a")})
    cfg_b = _cfg(**over, **{"train.logdir": str(tmp_path / "b")})
    whole = _train_on_batches(cfg_a, iter(host_batches), occluder_bank=bank, max_steps=8,
                              device="cpu")
    first = _train_on_batches(cfg_b, iter(host_batches), occluder_bank=bank, max_steps=4,
                              device="cpu")
    assert first.step == 4
    resumed = _train_on_batches(cfg_b, iter(host_batches), occluder_bank=bank, max_steps=8,
                                device="cpu")
    assert resumed.step == whole.step == 8
    # the same batches in the same order, restored exactly: equal on the CPU
    assert _state_equal(resumed.state_dict(), whole.state_dict())
    for run in ("a", "b"):
        with open(tmp_path / run / "history.json") as f:
            hist = json.load(f)
        assert [row["step"] for row in hist] == [2, 4, 6, 8]
        assert all(np.isfinite(row["loss"]) for row in hist)
        assert os.path.exists(tmp_path / run / "config.json")
    hist_a = json.load(open(tmp_path / "a" / "history.json"))
    hist_b = json.load(open(tmp_path / "b" / "history.json"))
    assert [r["loss"] for r in hist_a] == [r["loss"] for r in hist_b]


def test_train_profile_and_unported_options(tmp_path, host_batches, bank):
    cfg = _cfg(**{"train.num_steps": "5", "train.log_every": "5",
                  "train.checkpoint_every": "5", "train.profile_steps": "1",
                  "train.logdir": str(tmp_path / "p")})
    _train_on_batches(cfg, iter(host_batches), occluder_bank=bank, device="cpu")
    assert os.path.exists(tmp_path / "p" / "profile" / "trace.json")
    # in-loop validation is ported; the batch-fed loop needs the dataset it validates on
    with pytest.raises(ValueError, match="validate_every"):
        _train_on_batches(_cfg(**{"train.validate_every": "2", "train.num_steps": "4"}),
                          iter([]), occluder_bank=bank, device="cpu")
    with pytest.raises(NotImplementedError, match="fused_steps"):
        train(_cfg(**{"train.fused_steps": "2"}), iter([]))
    # the warm start and the 2.5D loss are ported (tests/test_torch_convert_backbone.py,
    # tests/test_torch_families.py): a missing backbone file is the caller's error
    with pytest.raises(FileNotFoundError, match="x.npz"):
        create_train_state(_cfg(**{"train.backbone_init": "x.npz"}), "cpu")


@pytest.mark.parametrize("how", ["built", "given", "off", "unmasked"])
def test_train_builds_the_background_bank_and_composites(tmp_path, host_batches, bank,
                                                         monkeypatch, how):
    """With `aug.background_prob` > 0 and masked data `train()` builds the
    bank at the source side (or takes the one it is given), moves it to the
    device once and composites every masked batch; with 0, or with batches
    that carry no mask, it builds and uses none."""
    built, composited = [], []
    real_get, real_composite = trainer_mod.get_background_bank, device_mod.composite_background

    def get_bank(bg_dir, side):
        built.append((bg_dir, side))
        return real_get(bg_dir, side=side)

    def composite(src, mask, bg_bank, bg_params):
        composited.append((tuple(bg_bank.shape), bg_bank.device.type))
        return real_composite(src, mask, bg_bank, bg_params)

    monkeypatch.setattr(trainer_mod, "get_background_bank", get_bank)
    monkeypatch.setattr(device_mod, "composite_background", composite)
    given = make_procedural_backgrounds(3, 128, 2)
    cfg = _cfg(**{"train.num_steps": "2", "train.log_every": "2",
                  "train.checkpoint_every": "2", "train.logdir": str(tmp_path),
                  "aug.background_prob": "0.0" if how == "off" else "0.7"})
    masked = [b if how == "unmasked" else _masked(b, seed=20 + i)[0]
              for i, b in enumerate(host_batches[:2])]
    state = _train_on_batches(cfg, iter(masked), occluder_bank=bank, device="cpu",
                              background_bank=given if how == "given" else None)
    assert state.step == 2
    assert built == ([(None, 128)] if how == "built" else [])
    n = {"built": 32, "given": 3, "off": 0, "unmasked": 0}[how]
    assert composited == ([((n, 128, 128, 3), "cpu")] * 2 if n else [])


def test_clip_uses_optax_rule():
    from metro_pose3d_tpu_torch.train.loop import clip_by_global_norm_

    g = [torch.tensor([3.0, 4.0]), torch.tensor([12.0])]
    norm = torch.nn.utils.get_total_norm(g)
    assert float(norm) == 13.0
    clip_by_global_norm_(g, 1.0, norm)
    want = optax.clip_by_global_norm(1.0).update([jnp.array([3.0, 4.0]), jnp.array([12.0])],
                                                 None)[0]
    for a, b in zip(g, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --- train() from datasets, through the port's host pipeline -----------------

# 4 + 4 rows: torch 2.13's CPU build (oneDNN 3.12) crashes in a convolution's
# backward at 8 threads on batches of 2, 3 or 6 rows of the tiny model
FEED = {"train.batch_size": "4", "train.batch_size_2d": "4", "data.workers": "2",
        "data.host_prep": "python", "train.log_every": "1"}


class CountingSynth(JaxSynth):
    """JaxSynth that counts the examples the loader prepares."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.prepared = 0

    def train_example(self, i):
        self.prepared += 1
        return super().train_example(i)


def _record_step_batches(monkeypatch):
    seen = []
    real = trainer_mod.make_train_step

    def make(*args, **kw):
        step = real(*args, **kw)

        def recorded(state, batch):
            seen.append({k: v.numpy().copy() for k, v in batch.items()})
            return step(state, batch)

        return recorded

    monkeypatch.setattr(trainer_mod, "make_train_step", make)
    return seen


def test_train_from_dataset_feeds_the_jax_batches(tmp_path, monkeypatch):
    """`train(cfg, dataset, dataset2d)` steps on the batches JAX's
    `mixed_batch_iterator` yields for the same config, with the occluder
    bank's real size (64) and the root joint from the dataset."""
    from metro_pose3d_tpu.train.trainer import mixed_batch_iterator as jax_mixed

    seen = _record_step_batches(monkeypatch)
    over = {**FEED, "train.num_steps": "3", "train.checkpoint_every": "3",
            "train.logdir": str(tmp_path)}
    state = train(_cfg(**over), JaxSynth(16), JaxSynth(16, two_d=True, seed=1), device="cpu")
    assert state.step == 3 and len(seen) == 3
    want = jax_mixed(apply_overrides(Config(), {**TINY, **over}), JaxSynth(16, port=False),
                     JaxSynth(16, port=False, two_d=True, seed=1), n_occluders=N_OCC)
    for got in seen:
        w = next(want)
        assert got.keys() == w.keys() and got["is_3d"].tolist() == [1] * 4 + [0] * 4
        for k in w:
            np.testing.assert_array_equal(got[k], w[k], err_msg=k)
    hist = json.load(open(tmp_path / "history.json"))
    assert [r["step"] for r in hist] == [1, 2, 3]
    assert all(0.0 <= r["loader_wait_share"] <= 1.0 for r in hist)


def test_train_from_dataset_resume_prepares_no_skipped_example(tmp_path):
    over = {**FEED, "train.num_steps": "6", "train.checkpoint_every": "3",
            "train.log_every": "3", "train.batch_size_2d": "0"}
    whole = train(_cfg(**over, **{"train.logdir": str(tmp_path / "a")}), JaxSynth(16),
                  device="cpu")
    ds = CountingSynth(16)
    cfg_b = _cfg(**over, **{"train.logdir": str(tmp_path / "b")})
    first = train(cfg_b, ds, max_steps=3, device="cpu")
    assert first.step == 3 and ds.prepared == 3 * 4  # no batch prepared beyond the run
    ds.prepared = 0
    resumed = train(cfg_b, ds, device="cpu")
    assert resumed.step == whole.step == 6
    assert ds.prepared == 3 * 4  # steps 4..6 only: the skipped batches were not prepared
    assert _state_equal(resumed.state_dict(), whole.state_dict())


@pytest.mark.parametrize("has_masks", [True, False])
def test_train_from_dataset_asks_the_dataset_for_masks(tmp_path, monkeypatch, has_masks):
    """`dataset.has_masks` (not the batches) decides the background bank, as
    the JAX trainer does; with it every batch carries masks and composites."""
    built, composited = [], []
    real_get, real_composite = trainer_mod.get_background_bank, device_mod.composite_background

    def get_bank(bg_dir, side):
        built.append((bg_dir, side))
        return real_get(bg_dir, side=side)[:3]

    def composite(src, mask, bg_bank, bg_params):
        composited.append(tuple(bg_bank.shape))
        return real_composite(src, mask, bg_bank, bg_params)

    monkeypatch.setattr(trainer_mod, "get_background_bank", get_bank)
    monkeypatch.setattr(device_mod, "composite_background", composite)
    seen = _record_step_batches(monkeypatch)
    cfg = _cfg(**{**FEED, "train.num_steps": "2", "train.checkpoint_every": "2",
                  "train.batch_size_2d": "0", "train.logdir": str(tmp_path)})
    train(cfg, JaxSynth(8, masks=has_masks), device="cpu")
    assert built == ([(None, 128)] if has_masks else [])
    assert composited == ([(3, 128, 128, 3)] * 2 if has_masks else [])
    assert all(("source_mask" in b) == has_masks for b in seen)
    if has_masks:
        assert max(b["bg_params"][:, 1].max() for b in seen) < 3  # indices cover the bank
