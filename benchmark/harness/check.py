"""How `correct` is decided: the outputs of the timed path, compared with the
plain reference (`benchmark/reference/`) on the same inputs, each number
against its limit in `benchmark/limits/<cell>.json`.

Serving: every answer the window produced is compared with the reference's
answer for the same pool batch; the numbers are the widest gaps over all of
them, and an answer that is missing, misshapen or not finite fails the run.

Training: the first `checked_steps` steps of the timed path's own state and
feed (set-up runs them) are followed by the reference from the same weights
on the same batches. The numbers: the first step's clipped gradient as Adam
got it (exp_avg / (1 - beta1)) and the parameters' change over the checked
steps, each as the worst leaf's gap of norms over the larger of the
reference leaf's norm and the median leaf's; the first gradient's angle to
the reference's (1 - cosine); the first step's loss and global gradient
norm. Leaves whose reference gradient is under a thousandth of the median
leaf's take no part in the change (round-off alone moves them under Adam).
The limits file names the numbers compared."""
from __future__ import annotations

import numpy as np
import torch

ADAM_BETA1 = 0.9
TINY_GRAD = 1e-3


def reference_serving(cfg: dict, pool: list, indices, ref, device, weights, precision: str,
                      amax, crops_of) -> dict:
    """-> {pool index: {output: numpy}} of the reference on those batches;
    `crops_of(ref, batch, side)` makes a batch's crops, as the kind feeds
    them."""
    out = {}
    with ref.no_tf32(), torch.no_grad():
        for i in sorted(set(indices)):
            b = {k: torch.from_numpy(v).to(device) for k, v in pool[i].items()}
            crops = crops_of(ref, b, cfg["proc_side"])
            res = ref.predict(cfg, weights, crops, b["intrinsics"],
                              cfg["joint_names"], precision, amax)
            out[i] = {k: v.cpu().numpy() for k, v in res.items()}
    return out


def serving_readings(answers: list, expected: dict, batch: int) -> dict:
    """answers: [(pool index, {output: numpy})] -> the gaps to the reference
    over every answer ("readings": the widest and the mean of each output),
    and the count of crops whose answer is missing, misshapen or not finite."""
    keys = {"rootrel_mm": "pose3d_rootrel", "pose2d_px": "pose2d_px", "abs_mm": "pose3d_abs"}
    diffs = {name: [] for name in keys}
    bad = 0 if answers else batch  # a window that answered nothing fails
    for i, got in answers:
        want = expected[i]
        ok = all(k in got and got[k].shape == want[k].shape and np.isfinite(got[k]).all()
                 for k in keys.values())
        if not ok:
            bad += batch
            continue
        for name, k in keys.items():
            diffs[name].append(np.abs(got[k].astype(np.float64) - want[k].astype(np.float64)))
    readings = {}
    for name, d in diffs.items():
        d = np.concatenate([x.ravel() for x in d]) if d else np.zeros(1)
        readings[name] = float(d.max())
        readings["mean_" + name] = float(d.mean())
    return {"readings": readings, "bad": bad}


def leaf_gaps(got: dict, want: dict, leaves) -> dict:
    """Each leaf's |norm(got) - norm(want)| over max(norm(want), the median
    leaf's norm(want))."""
    med = float(np.median([want[k] for k in leaves]))
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in leaves}


def training_readings(prog: dict, refr: dict) -> dict:
    """prog/refr: {"losses": [...], "global_norms": [...], "grad_norms": {leaf:
    norm}, "first_grads": {leaf: tensor}, "change_norms": {leaf: norm}} -> the
    numbers a limits file may compare, and the worst gradient leaves."""
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    leaves = list(refr["grad_norms"])
    med = float(np.median([refr["grad_norms"][k] for k in leaves]))
    moving = [k for k in leaves if refr["grad_norms"][k] >= TINY_GRAD * med]
    g = leaf_gaps(prog["grad_norms"], refr["grad_norms"], leaves)
    c = leaf_gaps(prog["change_norms"], refr["change_norms"], moving)
    dot = sum(float((prog["first_grads"][k].double() * refr["first_grads"][k].double()).sum())
              for k in leaves)
    norm = lambda d: np.sqrt(sum(v * v for v in d.values()))  # noqa: E731
    return {"grad_leaf": max(g.values()), "change_leaf": max(c.values()),
            "grad_cos": 1.0 - dot / (norm(prog["grad_norms"]) * norm(refr["grad_norms"])),
            "loss1_rel": rel(prog["losses"][0], refr["losses"][0]),
            "gnorm1_rel": rel(prog["global_norms"][0], refr["global_norms"][0]),
            "grad_median": float(np.median(list(g.values()))),
            "change_median": float(np.median(list(c.values()))),
            "worst_grad": {k: g[k] for k in sorted(g, key=g.get)[-3:]}}


def norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def reference_training(cfg: dict, traffic: dict, weights: dict, pool: dict, ref,
                       precision: str = "float32") -> dict:
    steps = traffic["checked_steps"]
    with ref.no_tf32():
        res = ref.train_steps(cfg, weights, pool["batches"][:steps], pool["occluders"],
                              pool["backgrounds"], cfg["joint_names"].index("pelv"),
                              traffic["start_step"], precision)
    return {"losses": res["losses"], "global_norms": res["grad_norms"],
            "grad_norms": norms(res["first_grads"]), "first_grads": res["first_grads"],
            "change_norms": {k: float((p.double() - weights[k].double()).norm())
                             for k, p in res["params"].items()}}


def verdict(readings: dict, limits: dict, bad: int) -> tuple:
    """-> (correct, [(name, value, limit)]) over the numbers the limits file
    names; a number it names that the readings lack fails, and so does a
    cell with no limits."""
    rows = [(k, readings.get(k), lim) for k, lim in limits.items()]
    ok = bad == 0 and bool(rows) and all(
        v is not None and np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
