"""Dataclass-based configuration system.

The reference scatters configuration across hard-coded module constants
(class lists at code/search_image.py:24-36, thresholds at
code/union_clip_llava2.py:153-162) plus a single YAML consumer for
Tip-Adapter (code/main_custom.py:19-25,256). Here everything is one
YAML-loadable dataclass tree; CLI subcommands consume it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ModelConfig:
    """Which towers to use for a retrieval pipeline."""

    # Named tower presets; see mmrs_tpu.models.configs.
    image_tower: str = "vit_b32"          # vit_b32 | vit_l14
    text_tower: str = "clip_text"         # clip_text | taiyi_roberta
    dtype: str = "bfloat16"               # float32 | bfloat16 | int8 (serving)
    param_dtype: str = "float32"          # master param dtype
    checkpoint_path: Optional[str] = None  # converted-weights checkpoint


@dataclass
class GalleryConfig:
    """Gallery (index) build settings."""

    root: str = ""                        # image folder root
    manifest_path: Optional[str] = None   # where the index manifest lives
    batch_size: int = 256
    embed_dim: int = 512
    shard_rows: int = 65536               # rows per persisted shard
    normalize: bool = True                # L2-normalize rows (reference does)
    extensions: Tuple[str, ...] = (
        ".jpg", ".jpeg", ".png", ".bmp", ".gif", ".tiff", ".webp",
    )


@dataclass
class SearchConfig:
    """Query engine settings."""

    top_k: int = 10
    logit_scale: float = 100.0            # reference uses 100.*feat@ref.T
    prototype: str = "mean"               # mean|image_text_mean|cluster|robust_mean
    outlier_percentile: float = 95.0      # robust_mean drop threshold
    cluster_k: int = 2                    # kmeans k for cluster prototypes
    cluster_balance_ratio: float = 0.2    # 20% balance rule (search_image.py:185-232)
    # ANN (index/ivf.py): "none" = exact scan (reference behavior);
    # "ivf" = clustered sub-linear search, recall tuned via ann_nprobe
    # (nprobe == n_clusters degrades to exact). 0 = auto sizing.
    ann: str = "none"
    ann_clusters: int = 0
    ann_nprobe: int = 0
    ann_bucket_cap: int = 0
    ann_train_iters: int = 10
    # > 0: measure recall on a strided row sample at engine start and
    # pick the smallest pow2 nprobe reaching it (index/ivf.tune_nprobe);
    # mutually exclusive with an explicit ann_nprobe. The tuned value
    # persists in the sidecar and is reused on restarts.
    ann_target_recall: float = 0.0
    # auto-cap slot budget: smallest cap covering this fraction of rows
    # in buckets (the rest spill to the exact per-query scan). Small-Q
    # latency is spill-bound on skewed corpora — raising cover trades
    # slot padding for spill bytes.
    # On skewed corpora the slots ceiling (ann_slots_frac, total slots
    # <= frac * rows) binds FIRST — raise both to actually cut spill.
    ann_cover: float = 0.98
    ann_slots_frac: float = 1.3


@dataclass
class CalibrationConfig:
    """Threshold calibration sweep settings.

    Both reference sweep styles are supported:
      - "linspace": 200 points between min/max observed sims
        (code/search_image.py:58-103)
      - "arange": fixed 0..1 step .001 grid on raw cosine (CLIP/lab3.py:39-65)
    """

    mode: str = "linspace"
    num_points: int = 200
    arange_stop: float = 1.001
    arange_step: float = 0.001


@dataclass
class CascadeConfig:
    """Dual-tower OR-gate + VLM-verify cascade (code/union_clip_llava2.py)."""

    en_thresholds: Dict[str, float] = field(default_factory=dict)
    cn_thresholds: Dict[str, float] = field(default_factory=dict)
    verifier: str = "none"                # none|stub|endpoint
    verifier_prompt: str = (
        "Does this image contain a {category}? "
        "Answer with ONLY a single word: 'yes' or 'no'."
    )


@dataclass
class DedupConfig:
    """Governance dedup settings."""

    mode: str = "embedding"               # exact|perceptual|embedding
    hamming_threshold: int = 5            # perceptual: dup if ANY dist <= 5
    similarity_threshold: float = 0.96    # embedding-space dup threshold
    keep_policy: str = "largest"          # largest|first|reference
    dry_run: bool = True


@dataclass
class AdapterConfig:
    """Tip-Adapter(-F) settings (code/main_custom.py keys)."""

    shots: int = 16
    augment_epoch: int = 10
    lr: float = 1e-3
    train_epoch: int = 20
    init_beta: float = 1.0
    init_alpha: float = 3.0
    search_hp: bool = True
    search_scale: Tuple[float, float] = (7.0, 3.0)
    search_step: Tuple[int, int] = (200, 20)
    cache_dir: str = "./caches"
    batch_size: int = 256


@dataclass
class MeshConfig:
    """Device-mesh layout. axes: data (batch/gallery rows), model (reserved TP)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_size: int = -1                   # -1: all devices on data axis
    model_size: int = 1


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    gallery: GalleryConfig = field(default_factory=GalleryConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    calibration: CalibrationConfig = field(default_factory=CalibrationConfig)
    cascade: CascadeConfig = field(default_factory=CascadeConfig)
    dedup: DedupConfig = field(default_factory=DedupConfig)
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    classes: List[str] = field(default_factory=list)
    prompts: Dict[str, str] = field(default_factory=dict)  # class -> prompt template
    seed: int = 0


def _from_dict(cls: Any, data: Dict[str, Any]) -> Any:
    """Recursively construct a dataclass from a plain dict."""
    if not dataclasses.is_dataclass(cls):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        ftype = fields[key].type
        # plain defaults AND default_factory defaults both drive the
        # dataclass/tuple coercions (tuple-typed fields here all use
        # plain defaults — factory-only sniffing left yaml round-trips
        # returning lists for Tuple fields)
        if fields[key].default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            default = fields[key].default_factory()  # type: ignore[misc]
        elif fields[key].default is not dataclasses.MISSING:
            default = fields[key].default
        else:
            default = None
        if dataclasses.is_dataclass(default) and isinstance(value, dict):
            kwargs[key] = _from_dict(type(default), value)
        elif isinstance(value, list) and isinstance(default, tuple):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load(path: str) -> Config:
    """Load a Config from a YAML file."""
    import yaml  # only config files need PyYAML, not the device path

    with open(path, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f) or {}
    return _from_dict(Config, data)


def loads(text: str) -> Config:
    import yaml

    data = yaml.safe_load(text) or {}
    return _from_dict(Config, data)


def dump(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False, allow_unicode=True)
