"""Typed pipeline configuration parsed from YAML.

Mirrors the reference's reflective dataclass parser and config tree
(reference: scripts/config/reconstruction_config.py:33-253,
pipeline_configs.py:17, yuv_to_rgb_config.py, depth_to_linear_config.py)
including str->float/int/bool/list coercion and `use_dataset_cache`
force-propagation, with the same dataclasses and field names as the JAX
build so the repo's YAMLs load unchanged.  The `device` key names the
accelerator, here the CUDA card (see mq3d_tpu_torch/device.py); the
entry points' own `device=` argument decides where a run goes.

YAML is read only by `PipelineConfigs.parse_config_yml`, which imports
`yaml` when it is called; building configs in Python needs no YAML.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Any, List

from mq3d_tpu_torch.device import config_device


@dataclass
class Yuv2RgbConfig:
    blur_filter: bool = False
    blur_threshold: float = 50.0
    exposure_filter: bool = False
    exposure_threshold_low: float = 0.02
    exposure_threshold_high: float = 0.02

    @classmethod
    def parse(cls, d: dict) -> "Yuv2RgbConfig":
        return _init_dataclass(cls, d)


@dataclass
class Depth2LinearConfig:
    clip_near_m: float = 0.1
    clip_far_m: float = 5.0
    use_cache: bool = True

    @classmethod
    def parse(cls, d: dict) -> "Depth2LinearConfig":
        return _init_dataclass(cls, d)


@dataclass
class DepthConfidenceEstimationConfig:
    target_frame_range: int = 10
    depth_max: float = 3.0
    error_threshold: float = 0.05
    skip_if_output_dir_exists: bool = True
    use_dataset_cache: bool = True
    use_multi_threading: bool = True  # accepted for YAML compat; the
    # fan-out is a batch dimension, not a process pool
    frames_per_batch: int = 16  # frames processed per device launch


@dataclass
class FragmentGenerationConfig:
    device: Any = None
    fragment_size: int = 100
    use_confidence_filtered_depth: bool = True
    confidence_threshold: float = 0.05
    valid_count_threshold: int = 4
    depth_max: float = 3.0
    odometry_loop_interval: int = 10
    overlap_ratio_threshold: float = 0.1
    loop_yaw_info_density_threshold: float = 0.3
    dist_threshold: float = 0.07
    edge_prune_threshold: float = 0.25
    use_dataset_cache: bool = True
    use_multi_threading: bool = False


@dataclass
class FragmentPoseRefinementConfig:
    device: Any = None
    use_confidence_filtered_depth: bool = True
    confidence_threshold: float = 0.05
    valid_count_threshold: int = 4
    voxel_size: float = 0.01
    block_resolution: int = 16
    block_count: int = 50_000
    depth_max: float = 1.5
    trunc_voxel_multiplier: float = 8.0
    use_pre_filtering: bool = True
    pre_filter_every_k_points: int = 30
    pre_filter_max_corr_dist: float = 0.1
    pre_filter_inlier_rmse_threshold: float = 0.05
    pre_filter_fitness_threshold: float = 0.2
    icp_voxel_sizes: List[float] = field(default_factory=lambda: [0.05, 0.025, 0.0125])
    max_corr_dists: List[float] = field(default_factory=lambda: [0.1, 0.05, 0.025])
    max_iterations: List[int] = field(default_factory=lambda: [50, 31, 14])
    relative_fitnesses: List[float] = field(default_factory=lambda: [1e-6, 1e-6, 1e-6])
    relative_rmses: List[float] = field(default_factory=lambda: [1e-6, 1e-6, 1e-6])
    icp_fitness_threshold: float = 0.2
    icp_inlier_rmse_threshold: float = 0.05
    dist_threshold: float = 0.07
    edge_prune_threshold: float = 0.25
    use_multi_threading: bool = False
    # Knobs of the JAX build (no reference counterpart):
    frames_per_batch: int = 64
    grid_dim: int = 160
    chunk_active_capacity: int = 12_288
    integrate_tile: int = 512
    alloc_pixel_stride: int = 2
    batch_pair_icp: bool = True  # wide/multi-chip pair-ICP launches
    # Exact CSR NN for the scene pose-graph information matrices instead
    # of the discrete-Voronoi field (same stats to <1%, ~30x slower at
    # production fragment sizes — ops/icp.py get_information_matrix_batch).
    exact_information_matrices: bool = False


@dataclass
class IntegrationConfig:
    device: Any = None
    use_confidence_filtered_depth: bool = True
    confidence_threshold: float = 0.05
    valid_count_threshold: int = 4
    voxel_size: float = 0.01
    block_resolution: int = 16
    block_count: int = 50_000
    depth_max: float = 1.5
    trunc_voxel_multiplier: float = 8.0
    # Knobs of the JAX build (no reference counterpart):
    frames_per_batch: int = 64  # frames fused per device launch
    # Chunks scan-fused into one launch (recon/integrate.py
    # integrate_multi); the port accepts it and runs chunks one by one.
    chunks_per_launch: int = 4
    grid_dim: int = 160  # dense slot-table extent (blocks/axis)
    chunk_active_capacity: int = 12_288  # max blocks touched per chunk
    integrate_tile: int = 512  # blocks per integration tile
    alloc_pixel_stride: int = 2  # pixel subsampling for allocation


@dataclass
class ColorOptimizationConfig:
    device: Any = None
    weight_threshold: float = 3.0
    estimated_vertex_number: int = -1
    interval: int = 10
    max_iteration: int = 100
    use_dataset_cache: bool = True
    min_triangle_count: int = 2000


@dataclass
class ColorAlignedDepthRenderingConfig:
    weight_threshold: float = 3.0
    estimated_vertex_number: int = -1
    min_triangle_count: int = 2000
    only_use_optimized_dataset: bool = True
    frames_per_batch: int = 16  # frames fused per render launch (the
    #   march's serial gather rounds amortize across the frame batch)
    # Read depth maps back as uint16 fixed point (step depth_max*1.5/65534,
    # 0.061 mm at 4 m — ~2.7x below the renderer's median error) instead of
    # float32: halves readback bytes on a bandwidth-bound transport.
    # Artifacts are still written float32.
    transfer_u16: bool = False


@dataclass
class ReconstructionConfig:
    device: Any = None
    use_dataset_cache: bool = True
    estimate_depth_confidences: bool = True
    optimize_depth_pose: bool = True
    use_fragment_dataset_cache: bool = True
    use_optimized_dataset_cache: bool = True
    use_colorless_vbg_cache: bool = True
    visualize_colorless_pcd: bool = False
    optimize_color_pose: bool = True
    visualize_colored_mesh: bool = False
    sample_point_cloud_from_colored_mesh: bool = True
    points_per_vertex_ratio: float = 1.0
    render_color_aligned_depth: bool = True

    confidence_estimation: DepthConfidenceEstimationConfig = field(init=False)
    fragment_generation: FragmentGenerationConfig = field(init=False)
    fragment_pose_refinement: FragmentPoseRefinementConfig = field(init=False)
    depth_integration: IntegrationConfig = field(init=False)
    color_optimization: ColorOptimizationConfig = field(init=False)
    color_aligned_depth_rendering: ColorAlignedDepthRenderingConfig = field(init=False)

    def __post_init__(self):
        self.confidence_estimation = DepthConfidenceEstimationConfig()
        self.fragment_generation = FragmentGenerationConfig(device=self.device)
        self.fragment_pose_refinement = FragmentPoseRefinementConfig(device=self.device)
        self.depth_integration = IntegrationConfig(device=self.device)
        self.color_optimization = ColorOptimizationConfig(device=self.device)
        self.color_aligned_depth_rendering = ColorAlignedDepthRenderingConfig()
        self._propagate_cache_flag()

    def _propagate_cache_flag(self):
        # use_dataset_cache at top level force-propagates into sub-configs
        # (reference reconstruction_config.py:247-251).
        if self.use_dataset_cache:
            for attr in vars(self):
                sub = getattr(self, attr)
                if hasattr(sub, "use_dataset_cache"):
                    sub.use_dataset_cache = True

    @classmethod
    def parse(cls, config_dict: dict) -> "ReconstructionConfig":
        raw_device = config_dict.get("device", "cpu")
        device = config_device(str(raw_device))
        config = _init_dataclass(cls, config_dict, parent_device=device)
        config._propagate_cache_flag()
        return config


_SCALAR_HINTS = {"float": float, "int": int, "bool": bool}
_LIST_ELEM_HINTS = {
    "List[float]": float,
    "list[float]": float,
    "List[int]": int,
    "list[int]": int,
    "List[str]": str,
    "list[str]": str,
}


def _init_dataclass(dc_cls, d: dict, parent_device=None):
    """Reflective dataclass construction with type coercion
    (reference reconstruction_config.py:184-245).

    Annotations arrive as strings (PEP 563), so coercion is keyed on the
    annotation text for scalars/lists and on a field-name registry for the
    nested sub-configs.
    """
    kwargs = {}
    post_inits = {}

    for f in fields(dc_cls):
        if f.name not in d:
            continue
        value = d[f.name]
        hint = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", "")

        if f.name == "device" and isinstance(value, str):
            value = config_device(value)
        elif f.name in _SUBCONFIG_BY_FIELD and isinstance(value, dict):
            value = _init_dataclass(
                _SUBCONFIG_BY_FIELD[f.name], value, parent_device=parent_device
            )
        elif hint in _SCALAR_HINTS:
            t = _SCALAR_HINTS[hint]
            if t is bool and isinstance(value, str):
                value = value.lower() in ("true", "1")
            elif not isinstance(value, bool) or t is not bool:
                value = t(value)
        elif hint in _LIST_ELEM_HINTS and isinstance(value, list):
            value = [_LIST_ELEM_HINTS[hint](v) for v in value]

        if f.init:
            kwargs[f.name] = value
        else:
            post_inits[f.name] = value

    if any(f.name == "device" for f in fields(dc_cls)) and "device" not in kwargs:
        kwargs["device"] = parent_device

    instance = dc_cls(**kwargs)
    for k, v in post_inits.items():
        setattr(instance, k, v)
    return instance

_SUBCONFIG_BY_FIELD = {
    "confidence_estimation": DepthConfidenceEstimationConfig,
    "fragment_generation": FragmentGenerationConfig,
    "fragment_pose_refinement": FragmentPoseRefinementConfig,
    "depth_integration": IntegrationConfig,
    "color_optimization": ColorOptimizationConfig,
    "color_aligned_depth_rendering": ColorAlignedDepthRenderingConfig,
}


@dataclass
class PipelineConfigs:
    yuv_to_rgb: Yuv2RgbConfig
    depth_to_linear: Depth2LinearConfig
    reconstruction: ReconstructionConfig

    @classmethod
    def parse_config_yml(cls, yml_path: Path) -> "PipelineConfigs":
        import yaml

        with open(yml_path, "r") as f:
            config_dict = yaml.safe_load(f)
        return cls.parse(config_dict)

    @classmethod
    def parse(cls, config_dict: dict) -> "PipelineConfigs":
        return cls(
            yuv_to_rgb=Yuv2RgbConfig.parse(config_dict.get("yuv_to_rgb", {})),
            depth_to_linear=Depth2LinearConfig.parse(config_dict.get("depth_to_linear", {})),
            reconstruction=ReconstructionConfig.parse(config_dict.get("reconstruction", {})),
        )


# TSDF settings of the JAX build's benchmark capture (bench.py): 1 cm voxels,
# 16^3 blocks, a 50k-block pool, a 160^3 slot table, 20-frame chunks.
PRODUCTION_INTEGRATION = dict(
    voxel_size=0.01, block_resolution=16, block_count=50_000, depth_max=4.0,
    trunc_voxel_multiplier=10.0, grid_dim=160, alloc_pixel_stride=2,
    chunk_active_capacity=12_288, integrate_tile=512, frames_per_batch=20,
)


def colorless_recipe(**depth_integration) -> PipelineConfigs:
    """The colorless reconstruction (the verify recipe): YUV -> PNG, depth ->
    linear, datasets (step 0, rebuilt) and TSDF integration (step 3), with
    confidence, pose optimisation, colour optimisation and raycast off and
    no volume cache.  `depth_integration` fields override the defaults."""
    return PipelineConfigs.parse({
        "yuv_to_rgb": {},
        "depth_to_linear": {"use_cache": True},
        "reconstruction": {
            "device": "cuda",
            "use_dataset_cache": False,
            "use_colorless_vbg_cache": False,
            "estimate_depth_confidences": False,
            "optimize_depth_pose": False,
            "optimize_color_pose": False,
            "render_color_aligned_depth": False,
            "depth_integration": dict({"use_confidence_filtered_depth": False},
                                      **depth_integration),
        },
    })
