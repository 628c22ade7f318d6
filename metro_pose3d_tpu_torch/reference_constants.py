"""Every numeric constant that affects parity with the reference, in one place.

The port's own copy of the JAX package's `reference_constants`; a test holds
the two together, value by value.

The reference (`isarandi/metro-pose3d`) spreads these across argparse flag
defaults in `src/options.py` and literals in `src/data/data_loading.py` /
`src/model/metro.py` (per SURVEY.md §3; the reference mount was empty during
the survey, so values carry provenance tags):

  [PAPER]   pinned by the MeTRo paper (Sárándi et al., IEEE FG 2020,
            arXiv:2003.02953) — stable.
  [VERIFY]  plausible default recalled from the public repo; re-pin against
            the real reference before using in cross-framework golden tests.

Framework-internal conventions (pixel-center convention, normalization) are
our own and are documented where defined; they only need to be self-consistent.
"""

# --- Crop / volume geometry -------------------------------------------------
PROC_SIDE = 256        # [PAPER] person-crop side in pixels
STRIDE = 16            # [PAPER] backbone output stride (dilated final stage)
HEATMAP_SIDE = PROC_SIDE // STRIDE  # 16x16 spatial heatmap
DEPTH = 8              # [VERIFY] depth slices of the volumetric heatmap
BOX_SIZE_MM = 2200.0   # [VERIFY] metric side of the cubic heatmap volume (mm)

# --- Image normalization (framework convention) ------------------------------
# uint8 [0,255] -> float in [-1, 1]; slim ResNet-v2 style ("x/127.5 - 1").
IMAGE_SCALE = 1.0 / 127.5  # multiplier applied to [0,255] intensities
IMAGE_OFFSET = -1.0        # additive offset: 0 -> -1, 255 -> +1

# --- Pixel convention (framework convention) ---------------------------------
# Pixel (i, j) has its *center* at continuous coordinate (i, j); an SxS image
# spans [-0.5, S-0.5]; its center is (S-1)/2; horizontal mirror is x -> S-1-x.
# All warp kernels, soft-argmax grids and flip-TTA use this consistently.

# --- Augmentation defaults ([VERIFY] magnitudes; structure is [PAPER]) --------
AUG_SHIFT_FRAC = 0.10      # random box-center translation, fraction of side
AUG_SCALE_DOWN = 0.75      # random zoom-out factor lower bound  (~ +-25%)
AUG_SCALE_UP = 1.25        # random zoom-in factor upper bound
AUG_ROT_MAX_DEG = 25.0     # random in-plane rotation
AUG_FLIP_PROB = 0.5        # horizontal flip
AUG_OCCLUDE_PROB = 0.7     # VOC occluder paste probability
AUG_COLOR_PROB = 0.8       # color jitter probability
TEST_BOX_EXPANSION = 1.0   # deterministic test-time square-box expansion

# --- Training defaults ([VERIFY]) ---------------------------------------------
ADAM_LR = 1e-4
BN_MOMENTUM = 0.99         # flax momentum convention: new = m*old + (1-m)*batch
BN_EPSILON = 1e-5          # batch-norm variance epsilon (slim default)
LOSS_2D_WEIGHT = 0.1       # weight of the 2D-head L1 loss vs the 3D L1 loss

# --- Eval protocol ------------------------------------------------------------
PCK_THRESHOLD_MM = 150.0   # [PAPER] 3DHP PCK threshold
AUC_THRESHOLDS_MM = tuple(range(0, 151, 5))  # [PAPER-style] AUC sweep 0..150mm

# --- Two-pass warp kernel numerics (framework convention) ---------------------
# Route a crop through the transposed-source kernel only when the default
# pass-1 row-crossing denominator is at most this fraction of the swapped
# one: ordinary crops keep the round-2 route bit-for-bit and only the
# near-±90° in-plane-rotation band (ADVICE r2: h11 - w*h21 -> 0) reroutes.
TWOPASS_SWAP_RATIO = 0.25
# Signed clamp keeping the row-crossing / Newton denominators away from 0;
# clamped rows are never blended with nonzero weight in pass 2 (they exist
# only to keep intermediate values finite).
TWOPASS_DEN_CLAMP = 1e-12
