"""Configuration system (the port's own copy of the JAX package's config).

A typed dataclass tree with a flat ``--section.field`` argparse overlay, so
one config object serves every entrypoint and a run's ``config.json`` from
either package loads into it unchanged. Fields that only the JAX package
reads (Pallas and TPU options) are kept so such files still parse.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field, fields
from typing import Optional, Sequence


@dataclass
class DataConfig:
    """Dataset artifact locations and static shapes."""

    dataset_dir: str = "data/preprocessed/vqa_v2"
    feature_path: str = ""  # HDF5/npz/raw dir of precomputed grid features
    vocab_path: str = ""  # question vocab json
    answer_vocab_path: str = ""  # top-K answer vocab json
    glove_path: str = ""  # filtered GloVe matrix (npz) or raw .txt
    max_question_len: int = 26  # questions are padded to this length
    image_size: int = 448  # raw-image path (end2end model); 448/32 -> 14
    grid_h: int = 14
    grid_w: int = 14
    feature_dim: int = 2048  # ResNet-101 conv5 channels
    pool5_dim: int = 2048
    num_answers: int = 2000  # top-K answer vocab size
    vocab_size: int = 8192  # question-word vocab size
    resample_negatives: bool = True  # vlmap: redraw negatives per batch
    image_dir: str = ""  # raw-image inputs (end2end)
    coco_split: str = ""  # "" derives the COCO split from the dataset split
    input_pipeline: str = "threads"  # "threads" | "grain"
    grain_workers: int = 0
    synthetic: bool = False  # synthetic data (tests, benchmarks)
    synthetic_size: int = 1024
    synthetic_layout: str = "flat"  # "flat" | "joined" (deduplicated store)


@dataclass
class ModelConfig:
    """Model family and dimensions."""

    model: str = "vqa_attention"  # registry key, see models/zoo.py
    word_dim: int = 300  # GloVe dimensionality
    rnn_dim: int = 512  # GRU hidden size
    fusion_dim: int = 1024  # joint embedding dim
    att_hidden: int = 512  # attention score-MLP hidden size
    answer_dim: int = 300  # answer-embedding space (ties to word_dim)
    dropout: float = 0.5
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    use_pallas: bool = True  # off: plain GRUs and gathered attention
    glimpses: int = 1  # attention glimpses (vqa_attention2 sets 2)
    bidirectional_desc: bool = False  # vlmap_description: BiGRU encoder
    dense_candidate_loss: bool = False  # vlmap: count-weighted dense CE
    rnn_variant: str = "cudnn"  # "cudnn" | "tf" (TF1-GRUCell-exact gates)
    fidelity_mode: bool = False  # TF1-exact GRU, f32, unfused attention
    resnet_checkpoint: str = ""  # end2end: torchvision resnet101 .pth
    resnet_stages: str = "3,4,23,3"  # bottleneck blocks per stage (101)
    resnet_width: int = 64  # stem channels
    num_tasks: int = 32  # vlmap (stage-1) specific
    task_dim: int = 64
    num_candidates: int = 512  # candidate answer-words per vlmap example


@dataclass
class TrainConfig:
    """Optimization and loop control."""

    batch_size: int = 256  # global batch
    learning_rate: float = 1e-3
    lr_decay_steps: int = 10_000
    lr_decay_rate: float = 0.9
    warmup_steps: int = 200
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip_norm: float = 10.0
    weight_decay: float = 0.0
    adam_mu_dtype: str = "float32"  # Adam first-moment storage dtype
    max_steps: int = 100_000
    log_every: int = 50
    eval_every: int = 1000
    checkpoint_every: int = 1000
    keep_checkpoints: int = 5
    seed: int = 123
    train_dir: str = "train_dir"
    resume: bool = True  # auto-resume from the latest checkpoint
    profile_start: int = 10
    profile_steps: int = 0  # 0 disables profiling
    prefetch_batches: int = 2  # host-side input prefetch depth
    steps_per_call: int = 1  # train steps fused into one dispatch
    pretrained_param_path: str = ""  # stage-1 checkpoint for transfer init
    freeze_params: str = ""  # comma-separated param names to freeze
    donate_state: bool = True
    remat: bool = False  # rematerialize the forward in the backward
    device_data_cache: bool = False  # whole dataset resident on the device
    resident_fused_attention: bool = True  # gather-free resident attention
    store_quantize: str = ""  # "" (bf16 store) | "int8"
    store_sharded: bool = False  # partition the resident store's rows
    sort_batch_by_image: bool = False


@dataclass
class MeshConfig:
    """Device-mesh layout of a multi-process run (``parallel/mesh.py``):
    the process group's start and coordinator, the (data, model) grid, and
    the tables row-sharded over the model axis. The axis names are the JAX
    package's and name nothing in the port."""

    data_axis: str = "data"
    model_axis: str = "model"
    num_data: int = -1  # -1: all visible devices on the data axis
    num_model: int = 1
    distributed: str = "auto"  # "auto" | "on" | "off"
    coordinator_address: str = ""
    num_processes: int = -1
    process_id: int = -1
    shard_params: str = ""  # param-path substrings sharded over the model axis


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # -- argparse overlay ---------------------------------------------------

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(
            description="tpu-vqa-transfer",
            formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        )
        for section_field in fields(cls):
            section_cls = section_field.default_factory  # type: ignore[union-attr]
            for f in fields(section_cls()):
                flag = f"--{section_field.name}.{f.name}"
                default = getattr(section_cls(), f.name)
                if f.type in ("bool", bool):
                    p.add_argument(
                        flag, type=_parse_bool, default=None, metavar="BOOL"
                    )
                else:
                    p.add_argument(flag, type=type(default), default=None)
        p.add_argument("--config_json", type=str, default=None,
                       help="JSON file of overrides, applied before flags")
        return p

    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None) -> "Config":
        args, _ = cls.parser().parse_known_args(argv)
        cfg = cls()
        if args.config_json:
            with open(args.config_json) as fh:
                cfg = cfg.replace_flat(json.load(fh))
        overrides = {
            k: v for k, v in vars(args).items()
            if v is not None and k != "config_json"
        }
        return cfg.replace_flat(overrides)

    def replace_flat(self, overrides: dict) -> "Config":
        """Apply ``{"section.field": value}`` overrides, returning a new Config."""
        sections = {f.name: dataclasses.replace(getattr(self, f.name))
                    for f in fields(self)}
        for key, value in overrides.items():
            section_name, _, field_name = key.partition(".")
            if not field_name:
                raise KeyError(f"override key must be section.field, got {key!r}")
            section = sections[section_name]
            if not hasattr(section, field_name):
                raise KeyError(f"unknown config field {key!r}")
            setattr(section, field_name, value)
        return Config(**sections)

    # -- train_dir naming (reference encodes hyperparams in the dir name) ---

    def run_name(self, stage: str) -> str:
        m, t = self.model, self.train
        return (
            f"{stage}_{m.model}_bs{t.batch_size}_lr{t.learning_rate:g}"
            f"_d{m.fusion_dim}_seed{t.seed}"
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


def _parse_bool(s: str) -> bool:
    if s.lower() in ("1", "true", "yes", "on"):
        return True
    if s.lower() in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"not a bool: {s!r}")
