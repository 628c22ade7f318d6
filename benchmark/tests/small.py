"""Cells at a size a CPU test holds: the tiny backbone at 64 px, a few rows,
float32 compute unless asked otherwise, the cell's own limits."""
import copy

from harness import spec

TINY = {"backbone": "tiny", "proc_side": 64}


def small_config(cfg: dict, dtype: str) -> dict:
    cfg = dict(cfg, **TINY, compute_dtype=dtype)
    if "calib_batch" in cfg:
        cfg["calib_batch"] = 4
    cfg["port"] = dict(cfg["port"], **{"model.backbone": "tiny", "model.proc_side": "64",
                                       "model.compute_dtype": dtype})
    return cfg


def small_cell(name: str, dtype: str = "float32") -> dict:
    c = copy.deepcopy(spec.cell(name))
    c["config"] = small_config(c["config"], dtype)
    tr = c["traffic"]
    if tr["kind"] == "train":
        tr.update(rows_3d=6, rows_2d=2, tile_side=96, pool=3, occluders=4, occluder_side=32,
                  backgrounds=2)
    else:
        tr.update(batch=3, tile_side=96, pool=3)
    return c
