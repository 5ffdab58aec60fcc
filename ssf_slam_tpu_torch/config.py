"""Typed configuration: the port's copy of what the SLAM step, the fused
step and training need from ``ssf_slam_tpu/config.py`` (LidarConfig,
FeatureConfig, OdometryConfig, EgoMotionConfig, MappingConfig,
FlowNetConfig, LossConfig, TrainConfig and PipelineConfig). Field names and
defaults are the JAX package's, ``PipelineConfig.variant`` (ONLY_PC)
included.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class Variant(enum.Enum):
    """Pipeline variants (launch-file equivalents): ONLY_PC geometric
    scan-to-scan, SEG the ground-truth mask on a provided flow, NO_SEG a GMM
    split of a provided flow, SF a GMM split of TFlow's flow, SSF TFlow's
    flow and seg head."""

    ONLY_PC = "onlypc"
    SEG = "seg"
    NO_SEG = "noseg"
    SF = "sf"
    SSF = "ssf"


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Scan geometry (include/header.h:37, src/frameFeature.cpp:57-71)."""

    n_scan_rows: int = 16
    # elevation model: 16-row velodyne rows span [-15, +15] deg
    vertical_fov_deg: Tuple[float, float] = (-15.0, 15.0)
    max_points: int = 8192  # padded scan size (N)


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Planar feature extraction (src/frameFeature.cpp:84-153)."""

    curvature_halfwin: int = 5  # 11-point curvature window
    plane_curv_max_16: float = 0.05
    plane_curv_max_64: float = 0.005
    plane_stride_16: int = 3
    plane_stride_64: int = 25
    row_margin_64: int = 5
    voxel_leaf: float = 0.2
    max_features: int = 4096  # padded feature-cloud size


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan registration (src/lidarOdometry_onlyPC.cpp): the
    ONLY_PC odometry, and the ring-diverse plane fit that ``geom_refine``
    also uses."""

    outer_iters: int = 2
    gn_iters: int = 8
    assoc_neighbors: int = 8
    assoc_normal_penalty: float = 2.0
    assoc_max_dist: float = 1.5
    range_sigma_scale: float = 30.0
    lm_lambda: float = 1e-3
    max_rot_step: float = 0.05
    max_trans_step: float = 0.5
    bev_init: bool = True
    hypothesis_pick: str = "bev"
    bev_plaus_gate: float = 0.4
    bev_plaus_rel: float = 0.5
    hyp_score_factor: float = 0.5
    hyp_separation_min: float = 0.15
    prior_trans_weight: float = 2.0
    prior_rot_weight: float = 50.0
    local_map_scans: int = 3
    knn_neighbors: int = 16
    plane_fit_points: int = 5
    max_fit_dist: float = 2.0
    range_gate_factor: float = 0.12
    coplanar_max: float = 0.15
    huber_delta: float = 0.1


@dataclasses.dataclass(frozen=True)
class EgoMotionConfig:
    """Flow-based ego-motion (scripts/PointCloudOdometry*.py)."""

    gmm_components: int = 2
    gmm_iters: int = 25
    gmm_reg_covar: float = 1e-6
    # Cauchy-IRLS refinement of the Kabsch fit on the learned-mask paths;
    # 0 = the reference's single unweighted SVD
    irls_iters: int = 2
    irls_sigma: float = 0.05  # expected static flow error (m)
    # seg-gated geometric refinement of the flow pose
    # (odometry/flow_refine.py)
    geom_refine: bool = False
    refine_src_stride: int = 4
    refine_outer: int = 2
    refine_gn_iters: int = 4
    refine_assoc_max_dist: float = 0.5
    refine_huber: float = 0.03
    refine_prior_rot: float = 250.0
    refine_prior_trans: float = 10.0
    refine_max_rot_step: float = 0.02
    refine_max_trans_step: float = 0.1
    refine_max_trans: float = 0.3
    refine_max_rot: float = 0.05
    refine_min_inliers: int = 256
    # residual trim of the static mask before it anchors geometry (the
    # keyframe seg-gate): points whose flow residual against the fitted
    # rigid motion exceeds this (m) count as movers
    refine_trim_resid: float = 0.15


@dataclasses.dataclass(frozen=True)
class MappingConfig:
    """Keyframe pose-graph back end (src/mapOptmization.cpp); the comments
    of ``ssf_slam_tpu/config.py::MappingConfig`` explain each gate."""

    max_keyframes: int = 512
    enable_loop_closure: bool = True
    keyframe_trans_gate: float = 1.0  # m
    keyframe_rot_gate: float = 0.01  # rad, any axis
    loop_search_radius: float = 15.0
    loop_time_gap: float = 20.0
    loop_min_keyframes: int = 5
    loop_skip_after_detect: int = 2
    loop_skip_after_close: int = 30
    loop_submap_halfwidth: int = 10
    icp_max_corr_dist: float = 50.0
    icp_iters: int = 30
    icp_fitness_gate: float = 1.0
    icp_rel_improve: float = 0.6
    submap_points: int = 16384
    posegraph_gn_iters: int = 8
    prior_rot_var: float = 1e-2
    prior_trans_var: float = 1e8
    odom_rot_var: float = 1e-6
    odom_trans_var: float = 1e-4
    # scan-to-submap refinement of each new keyframe
    scan_to_map_refine: bool = True
    refine_halfwidth: int = 6
    refine_min_keyframes: int = 2
    refine_max_corr_dist: float = 1.0
    refine_max_trans: float = 0.5
    refine_max_rot: float = 0.05
    refine_min_inliers: int = 64
    refine_stride: int = 4
    refine_submap_points: int = 2048
    refine_gn_iters: int = 4
    refine_huber: float = 0.1
    refine_prior_rot: float = 200.0
    refine_prior_trans: float = 50.0
    refine_max_rot_step: float = 0.05
    refine_max_trans_step: float = 0.2
    # seg-gate the keyframe map: drop features near the warped movers
    seg_gate_keyframes: bool = True
    seg_gate_radius: float = 1.0  # m


@dataclasses.dataclass(frozen=True)
class FlowNetConfig:
    """TFlow scene-flow network. Reference: TFlowV3_Occlussion.py:65-101."""

    npoint: int = 8192
    sa_npoints: Tuple[int, ...] = (2048, 512, 256, 128)
    sa_nsample: Tuple[int, ...] = (16, 16, 16, 8)
    sa_mlps: Tuple[Tuple[int, ...], ...] = (
        (32, 32, 64),
        (64, 64, 128),
        (128, 128, 256),
        (256, 256, 512),
    )
    cost_nsample: int = 16
    warp_nsample: Tuple[int, ...] = (3, 5, 7, 7)  # coarse -> fine
    upsample_k: Tuple[int, ...] = (5, 5, 7)
    flow_clamp: float = 50.0
    warp_clamp: float = 10.0
    upsample_clamp: float = 100.0
    leaky_rate: float = 0.1
    use_bn: bool = True
    joint_seg: bool = False  # 4-channel flow+seg head
    dtype: str = "float32"  # compute dtype of the net ("bfloat16" for speed)
    # "xla": exact-selection kNN everywhere; "banded": Morton-sorted clouds
    # and the banded CUDA kernels (ops/banded.py) wherever band_params tiles
    neighbor_backend: str = "xla"
    morton_extent: float = 64.0
    # run the cost volume's attention + weightnet + forward aggregation as
    # one CUDA kernel (ops/attention.py::cost_attention_fused) at inference
    # on the banded path; off by default, as in the JAX package
    fuse_attention: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """multiScaleLoss. Reference: TFlowV3_Occlussion.py:199-220."""

    alpha: Tuple[float, ...] = (0.02, 0.04, 0.08, 0.16)
    seg_weight: float = 1.0  # BCE scale for the joint-seg head
    # inverse-frequency (static, moving) class weights for the seg BCE
    # (labelweights, my_carla.py:379-393); None = unweighted
    seg_class_weights: Tuple[float, float] | None = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training harness. Reference: main_sju_occ_ros.py:411-452 + .sh files."""

    lr: float = 1e-3
    weight_decay: float = 1e-4
    decay_steps: int = 200000
    decay_rate: float = 0.7
    lr_min: float = 1e-5
    epochs: int = 600
    batch_size: int = 16
    seed: int = 1234


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    variant: Variant = Variant.ONLY_PC
    lidar: LidarConfig = LidarConfig()
    features: FeatureConfig = FeatureConfig()
    odometry: OdometryConfig = OdometryConfig()
    egomotion: EgoMotionConfig = EgoMotionConfig()
    mapping: MappingConfig = MappingConfig()
    flownet: FlowNetConfig = FlowNetConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    max_scans: int = 2048

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def for_variant(variant: Variant, **kw) -> PipelineConfig:
    """The default config of a pipeline variant."""
    return PipelineConfig(variant=variant, **kw)
