"""Joint metadata: names, skeleton edges, and left/right mirror mapping.

Responsibility-parity with the reference's `src/data/joint_info.py`
(SURVEY.md §3): the mirror-pair permutation is derived from `l`/`r` name
prefixes and drives both horizontal-flip augmentation and flip test-time
augmentation.

The port's own copy of the JAX package's `geom/joints.py` (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class JointInfo:
    """Immutable joint metadata for one skeleton convention.

    names: short joint names; a leading ``l``/``r`` marks a left/right joint
        (e.g. ``lwri`` mirrors ``rwri``).
    edges: skeleton bones as (parent, child) index pairs.
    """

    names: tuple
    edges: tuple

    @property
    def n_joints(self) -> int:
        return len(self.names)

    def index_of(self, name: str) -> int:
        return self.names.index(name)

    def ids(self, *names):
        return np.array([self.index_of(n) for n in names], np.int32)

    @property
    def mirror_mapping(self) -> np.ndarray:
        """Permutation p with p[i] = index of the left<->right mirrored joint.

        Derived from name prefixes: ``lxxx`` <-> ``rxxx``; other joints map to
        themselves. Used for flip augmentation and flip-TTA un-mirroring.
        """
        mapping = []
        for name in self.names:
            if name.startswith("l"):
                other = "r" + name[1:]
            elif name.startswith("r"):
                other = "l" + name[1:]
            else:
                other = name
            mapping.append(self.index_of(other) if other in self.names else self.names.index(name))
        return np.array(mapping, np.int32)

    @property
    def bones(self) -> np.ndarray:
        return np.array(self.edges, np.int32)

    def select_joints(self, indices) -> "JointInfo":
        """Sub-skeleton over `indices`; keeps edges with both ends selected."""
        indices = [int(i) for i in indices]
        remap = {old: new for new, old in enumerate(indices)}
        new_edges = tuple(
            (remap[a], remap[b]) for a, b in self.edges if a in remap and b in remap
        )
        return JointInfo(tuple(self.names[i] for i in indices), new_edges)


def _edges_by_name(names, pairs):
    idx = {n: i for i, n in enumerate(names)}
    return tuple((idx[a], idx[b]) for a, b in pairs)


# --- Human3.6M, 17 joints (reference `src/data/h36m.py` convention) -----------
_H36M_NAMES = (
    "pelv", "rhip", "rkne", "rank", "lhip", "lkne", "lank",
    "spin", "neck", "head", "htop", "lsho", "lelb", "lwri",
    "rsho", "relb", "rwri",
)
_H36M_EDGES = _edges_by_name(
    _H36M_NAMES,
    [
        ("pelv", "rhip"), ("rhip", "rkne"), ("rkne", "rank"),
        ("pelv", "lhip"), ("lhip", "lkne"), ("lkne", "lank"),
        ("pelv", "spin"), ("spin", "neck"), ("neck", "head"), ("head", "htop"),
        ("neck", "lsho"), ("lsho", "lelb"), ("lelb", "lwri"),
        ("neck", "rsho"), ("rsho", "relb"), ("relb", "rwri"),
    ],
)
H36M_17 = JointInfo(_H36M_NAMES, _H36M_EDGES)

# --- MPII, 16 joints (2D-only auxiliary supervision) ---------------------------
_MPII_NAMES = (
    "rank", "rkne", "rhip", "lhip", "lkne", "lank",
    "pelv", "thor", "neck", "htop",
    "rwri", "relb", "rsho", "lsho", "lelb", "lwri",
)
_MPII_EDGES = _edges_by_name(
    _MPII_NAMES,
    [
        ("pelv", "rhip"), ("rhip", "rkne"), ("rkne", "rank"),
        ("pelv", "lhip"), ("lhip", "lkne"), ("lkne", "lank"),
        ("pelv", "thor"), ("thor", "neck"), ("neck", "htop"),
        ("thor", "rsho"), ("rsho", "relb"), ("relb", "rwri"),
        ("thor", "lsho"), ("lsho", "lelb"), ("lelb", "lwri"),
    ],
)
MPII_16 = JointInfo(_MPII_NAMES, _MPII_EDGES)

# --- MPI-INF-3DHP, 17 joints (train) and the official 14-joint eval subset -----
_MPI3DHP_NAMES = (
    "htop", "neck", "rsho", "relb", "rwri", "lsho", "lelb", "lwri",
    "rhip", "rkne", "rank", "lhip", "lkne", "lank", "pelv", "spin", "head",
)
_MPI3DHP_EDGES = _edges_by_name(
    _MPI3DHP_NAMES,
    [
        ("pelv", "rhip"), ("rhip", "rkne"), ("rkne", "rank"),
        ("pelv", "lhip"), ("lhip", "lkne"), ("lkne", "lank"),
        ("pelv", "spin"), ("spin", "neck"), ("neck", "head"), ("head", "htop"),
        ("neck", "rsho"), ("rsho", "relb"), ("relb", "rwri"),
        ("neck", "lsho"), ("lsho", "lelb"), ("lelb", "lwri"),
    ],
)
MPI3DHP_17 = JointInfo(_MPI3DHP_NAMES, _MPI3DHP_EDGES)

# Official 3DHP test protocol evaluates 14 joints: all but pelv, spin, head.
MPI3DHP_EVAL_14_INDICES = np.array(
    [i for i, n in enumerate(_MPI3DHP_NAMES) if n not in ("pelv", "spin", "head")],
    np.int32,
)

# --- SMPL, 24 joints (3DPW ground truth; multi-person eval, config 5) ----------
_SMPL_NAMES = (
    "pelv", "lhip", "rhip", "spi1", "lkne", "rkne", "spi2", "lank", "rank",
    "spi3", "lfoo", "rfoo", "neck", "lcla", "rcla", "head", "lsho", "rsho",
    "lelb", "relb", "lwri", "rwri", "lhan", "rhan",
)
_SMPL_EDGES = _edges_by_name(
    _SMPL_NAMES,
    [
        ("pelv", "lhip"), ("lhip", "lkne"), ("lkne", "lank"), ("lank", "lfoo"),
        ("pelv", "rhip"), ("rhip", "rkne"), ("rkne", "rank"), ("rank", "rfoo"),
        ("pelv", "spi1"), ("spi1", "spi2"), ("spi2", "spi3"), ("spi3", "neck"),
        ("neck", "head"),
        ("spi3", "lcla"), ("lcla", "lsho"), ("lsho", "lelb"), ("lelb", "lwri"),
        ("lwri", "lhan"),
        ("spi3", "rcla"), ("rcla", "rsho"), ("rsho", "relb"), ("relb", "rwri"),
        ("rwri", "rhan"),
    ],
)
SMPL_24 = JointInfo(_SMPL_NAMES, _SMPL_EDGES)

# The common 3DPW reduced evaluation subset (14 LSP-style joints).
SMPL_EVAL_14_INDICES = np.array(
    [SMPL_24.index_of(n) for n in (
        "rank", "rkne", "rhip", "lhip", "lkne", "lank",
        "rwri", "relb", "rsho", "lsho", "lelb", "lwri", "neck", "head",
    )],
    np.int32,
)

_REGISTRY = {
    "h36m_17": H36M_17,
    "mpii_16": MPII_16,
    "mpi_inf_3dhp_17": MPI3DHP_17,
    "smpl_24": SMPL_24,
}


def get_joint_info(name: str) -> JointInfo:
    return _REGISTRY[name]
