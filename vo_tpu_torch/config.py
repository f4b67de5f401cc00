"""Typed configuration for the whole engine (the port's own copy of the JAX package's config).

Every class, field and default equals the JAX package's, the fields this port
does not read yet included, so that the two compare field for field
(``convert.config_from_reference`` copies one into the other). The module
imports the standard library only.

The reference has exactly one flag (``view_3D``, VO.m:6) and hard-codes every
other constant inline: viz every 100 frames (VO.m:168), landmark stride 2
(CreateLandmarksFromFeatures.m:4), depth gate 80 m
(CreateLandmarksFromFeatures.m:13), SIFT/matcher/RANSAC parameters buried in
MATLAB toolbox defaults. Here every knob is an explicit dataclass field; the
defaults replicate the MATLAB behavior.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SIFTConfig:
    """Scale-space detector + descriptor parameters.

    Defaults mirror MATLAB detectSIFTFeatures / extractFeatures(...,"SIFT")
    (VO.m:79-84): ContrastThreshold 0.0133, EdgeThreshold 10, 3 layers per
    octave, sigma 1.6 [MATLAB docs — not in repo].
    """

    n_octaves: int = 4
    scales_per_octave: int = 3
    sigma0: float = 1.6
    contrast_threshold: float = 0.0133
    edge_threshold: float = 10.0
    # Static per-image keypoint capacity: every set is this long with a
    # validity mask. Every keypoint-proportional stage (subpixel refine,
    # orientation hists, descriptors) scales with it. The KITTI-resolution
    # feed detects ~1200 raw keypoints (multi-peak duplicates included), so
    # the top-1024-by-response cut drops the ~16% weakest, at no measurable
    # cost in accuracy.
    max_keypoints: int = 1024
    descriptor_patch: int = 16  # 16x16 gradient patch -> 4x4x8 histogram
    ori_bins: int = 36
    # 2 = Lowe/MATLAB multi-peak orientations (duplicate keypoint per
    # histogram peak >= 80% of max); 1 = dominant peak only. The duplicate
    # set shares the max_keypoints capacity. Default 2 matches MATLAB
    # detectSIFTFeatures (VO.m:79-84), measured +19% matches (VERDICT r2).
    n_orientations: int = 2
    upsample: bool = False  # MATLAB does not upsample by default
    # Fast path: dense 8-bin orientation maps + row-gather descriptors
    # (frontend.dense_desc) instead of per-keypoint scalar-gather sampling.
    # The port implements only this path (the Lowe-exact oracle path lives
    # in the JAX package).
    fast_descriptor: bool = True
    # The hand-written kernels (frontend.kernels) for the extrema scores, the
    # bin maps and the blurs of the pyramid and the maps; False takes their
    # plain versions. The name is the JAX package's, whose kernels are Pallas.
    use_pallas: bool = True


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching parameters.

    MATLAB matchFeatures defaults (VO.m:87): Metric SSD, MatchThreshold 10
    (percent of max distance), MaxRatio 0.6 (Lowe ratio), mutual uniqueness
    off [MATLAB docs].
    """

    max_ratio: float = 0.6
    match_threshold: float = 10.0  # percent of the max possible SSD distance
    # DELIBERATE deviation from MATLAB's Unique=false (VO.m:87), measured
    # (VERDICT r3 item 6): on the noisy 600-frame matrix, mutual=False runs
    # ATE 0.193 m with 56 mean cascade tracks vs 0.124 m / 73 tracks with
    # the cross-check on — without it, ambiguous one-to-many matches break
    # the 4-view cascade's 1:1 row alignment and fewer consistent tracks
    # survive. Both semantics stay tested (tests/test_matcher_unique.py).
    mutual: bool = True
    tile: int = 512  # distance-matrix tile of the JAX package's matcher kernel (unread here)


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """RANSAC-P3P parameters.

    MATLAB estworldpose defaults (VO.m:123-127): MaxReprojectionError 1 px,
    Confidence 99 %, MaxNumTrials 1000 [MATLAB docs]. Here a FIXED
    hypothesis batch runs (no data-dependent early exit) — all hypotheses solved
    and scored at once.
    """

    n_hypotheses: int = 512
    max_reproj_err_px: float = 1.0
    refine_iters: int = 10
    min_points: int = 6  # below this, fall back to constant-velocity model


@dataclasses.dataclass(frozen=True)
class LandmarkConfig:
    """Global map parameters (CreateLandmarksFromFeatures.m)."""

    capacity: int = 1_000_000
    min_depth: float = 0.0  # reference keeps z > 0 (CreateLandmarksFromFeatures.m:9)
    max_depth: float = 80.0  # reference gate (CreateLandmarksFromFeatures.m:13)
    stride: int = 2  # reference keeps every 2nd new point (CreateLandmarksFromFeatures.m:4)


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Sliding-window bundle adjustment (north-star extension; no reference counterpart)."""

    window: int = 10  # keyframes in the window
    # Landmark capacity of the dense [window, max_points] observation grid.
    # On the noisy 600-frame feed the assembled windows hold p50=77 /
    # max=122 active landmarks with at most 220 multi-view candidates before
    # the capacity cap (telemetry: ba_active_p50/ba_candidate_max in the
    # refiner's stats); 512 keeps >2x headroom over the densest window
    # observed, and a larger grid is mostly padding.
    max_points: int = 512
    iters: int = 8
    damping: float = 1e-3
    huber_px: float = 1.0
    keyframe_every: int = 5
    # Assembly-time reprojection gate: tracked observations are NOT RANSAC-
    # verified, and one mis-associated track (100s of px of residual) can
    # out-lever every inlier in the window. Drift within a short window is
    # far below this gate; mis-associations are far above it.
    obs_gate_px: float = 12.0
    # Adaptive track-consistency gate (ba_runner._assemble): drop tracks
    # whose worst window residual exceeds mult x the median track maximum
    # (floored) — sub-pixel-biased tracks that pass the obs gate but are
    # not consistent with any single 3D point.
    track_gate_mult: float = 2.5
    track_gate_floor_px: float = 1.0
    # Trust-region prior pulling each window pose toward its VO-chained
    # initial value (units: 1/sigma^2; sigma_t = 5 cm, sigma_r ~ 0.5 deg).
    # The VO initials come from hundreds of RANSAC-verified correspondences
    # per frame; the window's multi-view tracks can be few and weakly
    # conditioned (far points), and without this prior the reprojection-only
    # optimum wanders decimeters off in the sliding null space, compounding
    # through rigid re-anchoring into unbounded trajectory error.
    prior_t_w: float = 400.0
    prior_r_w: float = 1.5e4
    # Post-solve sanity gate: reject a solve whose last-keyframe correction
    # exceeds plausible intra-window drift (divergence protection).
    max_corr_t: float = 1.0  # meters
    max_corr_deg: float = 2.0


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop closure (north-star extension; no reference counterpart — the
    reference's trajectory drifts unbounded, 4500/map.png).

    Candidates come from TWO channels OR'd together (slam.loop_closure):
    metric pose proximity (``radius``) and appearance retrieval — cosine
    similarity of a per-keyframe global descriptor (masked mean of its SIFT
    descriptors, one matvec against the archive) — so closures still fire
    when accumulated drift exceeds ``radius`` (VERDICT r2 item 5).
    """

    radius: float = 10.0  # meters — candidate gate on translation distance
    min_gap: int = 20  # keyframes — skip recent neighbors
    # Geometric verification threshold. Calibrated at reference feed
    # severity (BIGRUN_r05 regime, sensor sigma ~0.08): a true same-heading
    # revisit yields ~45 P3P inliers through the full-query match while
    # crossing-angle revisits and junk candidates measure 2-5 — 15 sits
    # 3x above the false-positive band and half the true-positive level.
    # (r4's 25 was calibrated on the near-noiseless feed, where the same
    # pair yields ~68; at severity it silently disabled closure.)
    min_inliers: int = 15
    match_capacity: int = 512
    # Verification matcher overrides (the production matcher's strict
    # ratio 0.6 + mutual filter is tuned for temporal tracking where wrong
    # matches poison the cascade; verification feeds RANSAC, which rejects
    # outliers geometrically — permissive matching measured 21 -> 28
    # raw matches on the severity feed's true revisit with inliers intact).
    verify_ratio: float = 0.8
    verify_mutual: bool = False
    max_keyframes: int = 512  # node capacity of the global graph
    max_loop_edges: int = 64
    odometry_weight: float = 1.0
    loop_weight: float = 30.0
    graph_iters: int = 12
    appearance: bool = True  # enable the appearance-retrieval channel
    appearance_top_k: int = 3  # candidates proposed by appearance per keyframe
    appearance_min_sim: float = 0.80  # cosine-similarity floor for proposals
    candidate_budget: int = 4  # candidates verified per keyframe (ONE fused dispatch)
    # Benefit gate: a verified loop whose implied pose correction is below
    # the expected noise is mostly measurement noise — applying it DEGRADES
    # an accurate trajectory (measured: 50 closures on a 0.13 m-ATE run
    # pushed ATE to 0.64 m). The gate is DRIFT-AWARE (VERDICT r3 item 3):
    #   gate = clip(drift_frac * path_since_candidate,
    #               min_correction_floor, min_correction)
    # so a fixed 1.0 m threshold no longer disables closure whenever the
    # accumulated drift is sub-meter (every committed run through r3).
    min_correction: float = 1.0  # meters — gate CAP (long paths)
    # Verification-noise floor. Recalibrated 0.3 -> 0.5 for the full-query
    # permissive verifier (higher Z noise than the old stereo-subset
    # matcher): at 0.3 a single noise-closure with disc 0.315 m fired on
    # the clean 600-frame out-and-back feed and degraded vo_lc's ATE
    # 0.10 -> 0.44 m; at 0.5 it is skipped (vo_lc == vo there) while the
    # reference-severity closures (disc 1-9 m) are untouched — BIGRUN_r05
    # accuracy reproduces bit-identically.
    min_correction_floor: float = 0.5
    # Gate slope per meter traveled since the candidate. Must sit BELOW the
    # platform's actual drift rate or closure is again unreachable: the
    # noisy 600-frame matrix measured ~0.65 m/km VO drift, so 0.5 m/km
    # keeps the gate under real drift while scaling past the floor.
    drift_frac: float = 0.0005
    # After an accepted closure, skip detection for this many keyframes: a
    # long revisit otherwise re-verifies + re-solves the global graph at
    # EVERY keyframe.
    # 10 -> 5 at reference feed severity: drift accrues fast enough
    # (~7 m/km) that halving the cadence measurably tightens the
    # trajectory (vo_lc xz mean 5.33 -> 3.36 m, BIGRUN_r05 calibration).
    cooldown: int = 5
    # After ANY verification round (accepted or not), skip this many
    # keyframes before dispatching another: revisit candidates persist for
    # tens of keyframes, and each round costs a device round trip.
    # 1 = verify at every keyframe outside accepted-
    # closure cooldowns — at reference severity the extra rounds feed the
    # small-disc constraint accumulation (slam.loop_closure), worth more
    # than the saved latency.
    verify_cooldown: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the distributed components."""

    data: int = 1  # frame-parallel axis (front-end)
    model: int = 1  # hypothesis/landmark-shard axis (RANSAC, BA)
    axis_names: Tuple[str, str] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    sift: SIFTConfig = dataclasses.field(default_factory=SIFTConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    ransac: RansacConfig = dataclasses.field(default_factory=RansacConfig)
    landmarks: LandmarkConfig = dataclasses.field(default_factory=LandmarkConfig)
    ba: BAConfig = dataclasses.field(default_factory=BAConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    max_tracks: int = 1024  # capacity of the temporal-track arrays
    # Frames per group on the runner's plain path (pipeline.vo_step_multi):
    # detection batches across all frames of a group. Trajectories are
    # bit-identical for any value.
    fused_group: int = 2
    view_3d: bool = True  # the reference's single flag (VO.m:6)
    viz_every: int = 100  # VO.m:168
    dtype: str = "float32"
    # The reference's matmul precision names: "float32" / "highest", or
    # "default", its accelerator's reduced rate. On the H100 utils.precision
    # runs every one of them in float32: TF32 there flickers a quarter of the
    # keypoints and multiplies the 200-frame ATE by eight.
    matmul_precision: str = "default"
