"""The reference against the system on the CPU, the one place where both are
imported: every cell's path at a small size in float32 (where the two
agree to round-off), and the serving path at the published widths."""
import copy

import pytest
import torch

from harness import program, spec, weights
from harness.cell import Record, make
from small import small_cell

# float32 on the CPU: the system's kernels run their plain twins, so the
# two sides differ by summation order at most
SERVE_TOL = {"rootrel_mm": 1e-2, "pose2d_px": 1e-3, "abs_mm": 5e-2}
TRAIN_TOL = {"loss1_rel": 1e-5, "gnorm1_rel": 1e-4, "grad_cos": 1e-4, "grad_leaf": 1e-2,
             "change_leaf": 1e-2}


def _run(cell, seed=2**31 + 77):
    c = make(cell, "cpu")
    c.prepare(seed)
    c.warm()
    c.window(0.2, Record(c, 0.0))
    return c.readings()


@pytest.mark.parametrize("name", ["bf16-crop-tta-b64", "int8-crop-tta-b128",
                                  "bf16-tile-tta-b64"])
def test_serving_cells_agree_in_float32(name):
    readings, bad = _run(small_cell(name))
    assert bad == 0
    for k, tol in SERVE_TOL.items():
        assert readings[k] <= tol, (k, readings)


def test_train_cell_agrees_in_float32():
    torch.set_num_threads(4)
    readings, bad = _run(small_cell("bf16-train-b96"))
    assert bad == 0
    for k, tol in TRAIN_TOL.items():
        assert readings[k] <= tol, (k, readings)


def test_the_reference_names_the_systems_parameters_at_published_widths():
    cfg = spec.config("metro-r50v2-256-bf16")
    ref = spec.reference(cfg)
    model = program.build_model(cfg, "cpu", train=False)
    assert program.parameter_shapes(model) == {k: tuple(v) for k, v in
                                              ref.parameter_shapes(cfg).items()}


def test_crop_in_serving_at_published_widths():
    """R50 v2 at 256 px, stride 16, one batch of 2 crops, float32."""
    cell = copy.deepcopy(spec.cell("bf16-crop-tta-b64"))
    cell["config"] = dict(cell["config"], compute_dtype="float32",
                          port={"model.compute_dtype": "float32"})
    cell["traffic"].update(batch=2, pool=1, warmup_batches=1)
    readings, bad = _run(cell)
    assert bad == 0 and readings["rootrel_mm"] < 0.05 and readings["abs_mm"] < 0.5, readings


def test_weights_are_the_seeds():
    shapes = {"a.conv1.weight": (4, 3, 3, 3), "a.bn1.var": (4,), "head3d.weight": (2, 4, 1, 1)}
    w1, w2 = weights.make(shapes, 5, "cpu"), weights.make(shapes, 5, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in shapes)
    assert (w1["a.bn1.var"] > 0).all()
