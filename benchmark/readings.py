"""Readings that the correctness limits of a cell are set from (not run by
`run.py`): on the card, at the cell's own sizes and load, in one process,

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 101,...] [--fault-seeds 201,...] [--seconds 3]

prints one JSON line a reading:
  program  the system's numbers over a short window (the lower readings);
  control  the cell's control, from its limits file: the reference in a
           lower precision ("reference_precision") put in the system's
           place, against the cell's reference;
  fault    training only: the reference with half of each batch left out,
           the mean taken over the rest, in the system's place;
and a last line with the largest program reading and the smallest control
and fault reading of each number."""
import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def half_rows(batch: dict) -> dict:
    n = batch["is_3d"].shape[0]
    return {k: (v[:n // 2] if v.dim() and v.shape[0] == n else v) for k, v in batch.items()}


def program_readings(cell: dict, device, seed_list, seconds: float):
    """Yields (seed, readings, failed crops, crops/s) of the system's short
    windows, the system built once."""
    from harness.cell import Record, make

    c = make(cell, device)
    for s in seed_list:
        c.prepare(s)
        c.warm()
        rec = Record(c, 0.0)
        c.window(seconds, rec)
        readings, bad = c.readings()
        yield s, readings, bad, rec.items / rec.window_s


def control_readings(cell: dict, device, seed_list):
    """Yields (seed, readings, failed crops) of the cell's control."""
    from harness.cell import make

    c = make(cell, device)
    c.free_program()
    for s in seed_list:
        c.prepare_inputs(s)
        yield (s, *c.control_readings(cell["limits"]["control"]["reference_precision"]))


def fault_readings(cell: dict, device, seed_list):
    """Training: yields (seed, readings) of the reference with half of each
    batch left out in the system's place."""
    from harness import check
    from harness.cell import make

    c = make(cell, device)
    c.free_program()
    for s in seed_list:
        c.prepare_inputs(s)
        full = c.reference_steps(c.cfg["reference_precision"])
        c.inputs["batches"] = [half_rows(b) for b in c.inputs["batches"]]
        yield s, check.training_readings(c.reference_steps(c.cfg["reference_precision"]), full)


def main(argv, cell=None) -> int:
    """`cell` replaces the workload's files (tests run a small one on the CPU)."""
    import torch

    from harness import spec

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    cell = cell or spec.cell(args.workload)
    device = torch.device(args.device)
    lows, highs = {}, {}

    def emit(kind, seed, readings, bad=0, **extra):
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed,
                          "readings": readings, "bad": bad, **extra}), flush=True)
        for k, v in readings.items():
            if isinstance(v, dict):
                continue
            (lows if kind == "program" else highs).setdefault(k, []).append(v)

    for s, r, bad, rate in program_readings(cell, device, args.seeds, args.seconds):
        emit("program", s, r, bad, items_per_s=rate)
    for s, r, bad in control_readings(cell, device, args.control_seeds):
        emit("control", s, r, bad)
    for s, r in fault_readings(cell, device, args.fault_seeds):
        emit("fault", s, r, fault="half_batch")
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"workload": args.workload, "lower": {k: max(v) for k, v in lows.items()},
                      "upper": {k: min(v) for k, v in highs.items()}, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    for var, sub in {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
                     "CUDA_CACHE_PATH": "nv_compute_cache"}.items():
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    sys.exit(main(sys.argv[1:]))
