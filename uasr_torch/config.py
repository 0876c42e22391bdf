"""Typed configuration tree, YAML-loadable (copy of ``uasr.config``).

The port keeps its own copy of the dataclasses it needs so that it never
imports the JAX package. Field names and defaults are those of
``uasr/config.py``. The SSL section is not ported yet (ROADMAP.md
Queue 1, item 10) and is absent here, so a recipe that sets it fails to
load with "unknown config keys".

``yaml`` is imported inside ``load_config`` only: the port's runtime
needs no PyYAML unless a recipe file is read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


def _build(cls, data: dict[str, Any]):
    """Recursively construct a dataclass from a plain dict, erroring on
    unknown keys so recipe typos fail loudly."""
    if data is None:
        data = {}
    import typing

    hints = typing.get_type_hints(cls)  # resolves string annotations
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name in fields:
        if name not in data:
            continue
        val = data[name]
        ftype = hints.get(name)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[name] = _build(ftype, val)
        else:
            kwargs[name] = val
    return cls(**kwargs)


@dataclass
class FrontendConfig:
    """Acoustic frontend parameters (python_speech_features / Kaldi
    conventions: pre-emphasis 0.97, 25 ms / 10 ms framing, Hamming
    window, mel filterbank, log, optional DCT->MFCC, deltas, CMVN,
    splice + downsample)."""

    sample_rate: int = 16000
    feature_type: str = "fbank"  # fbank | mfcc
    preemph: float = 0.97
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    window: str = "hamming"  # hamming | hann | povey | rect
    n_fft: int = 512
    num_mel_bins: int = 80
    low_freq: float = 0.0
    high_freq: float | None = None  # None -> sample_rate / 2
    num_ceps: int = 13  # MFCC only
    cep_lifter: float = 22.0  # MFCC only
    use_energy: bool = False  # MFCC: replace c0 with log energy
    add_deltas: bool = False  # append delta + delta-delta
    delta_window: int = 2
    cmvn: str = "utterance"  # none | utterance | global | streaming
    cmvn_stats_path: str | None = None  # for cmvn == "global"
    splice_left: int = 0  # frames of left context to splice
    splice_right: int = 0
    downsample: int = 1  # keep every k-th frame after splicing
    # SpecAugment (training-time only)
    specaug_freq_mask: int = 0
    specaug_freq_masks: int = 0
    specaug_time_mask: int = 0
    specaug_time_masks: int = 0
    # fused log-mel kernel (K1) on CUDA tensors, its plain version on CPU
    use_pallas: bool = True
    # GEMM tier of the DFT/mel products: "highest" = full f32,
    # "high" = bf16 hi/lo three-product split, "bfloat16" = one bf16
    # product with f32 accumulation
    precision: str = "highest"  # highest | high | bfloat16
    streaming_chunk_frames: int = 0  # >0 -> chunked streaming frontend

    @property
    def frame_length(self) -> int:
        return int(round(self.sample_rate * self.frame_length_ms / 1000.0))

    @property
    def frame_shift(self) -> int:
        return int(round(self.sample_rate * self.frame_shift_ms / 1000.0))

    @property
    def base_dim(self) -> int:
        d = self.num_ceps if self.feature_type == "mfcc" else self.num_mel_bins
        if self.add_deltas:
            d *= 3
        return d

    @property
    def dim_input(self) -> int:
        """Model input dim after splicing (reference: `dim_input`)."""
        return self.base_dim * (self.splice_left + 1 + self.splice_right)


@dataclass
class ModelConfig:
    """Encoder, generator and critic hyperparameters (same fields as
    ``uasr.config.ModelConfig``)."""

    # conv_bigru | lc_bigru | uni_gru | cnn | classifier | transformer
    # | conformer
    encoder: str = "conv_bigru"
    lc_chunk: int = 16
    lc_lookahead: int = 8
    hidden_size: int = 256
    num_gru_layers: int = 2
    gru_unroll: int = 4
    gru_remat: bool = False
    # BiGRU recurrence through the hand-written kernel (K2) on CUDA
    # tensors, its plain version elsewhere
    gru_pallas: bool = False
    attn_pallas: bool = False
    conv_channels: int = 64
    num_conv_layers: int = 2
    conv_kernel: int = 3
    conv_time_stride: int = 2  # per conv layer; total downsample = stride**layers
    conv_front: str = "conv2d"  # conv2d | patch
    dropout: float = 0.0
    transformer_layers: int = 4
    num_heads: int = 8
    ffn_dim: int = 0  # 0 -> 4 * hidden_size
    conformer_kernel: int = 15
    conformer_rel_clip: int = 64
    sequence_shard: bool = False
    classifier_hidden: int = 512
    classifier_layers: int = 2
    classifier_context: int = 4
    disc_channels: int = 256
    disc_layers: int = 3
    disc_kernel: int = 5
    dtype: str = "float32"  # compute dtype: float32 | bfloat16
    int8_compute: bool = False


@dataclass
class CTCConfig:
    blank_id: int = 0
    beam_width: int = 8
    use_beam: bool = False
    use_pallas: bool = False  # CTC loss kernels (training slice)
    lm_path: str | None = None
    lm_weight: float = 0.5
    lm_bonus: float = 0.0
    use_viterbi: bool = False
    viterbi_self_loop: float = 0.75
    viterbi_blank_prob: float = 0.1
    viterbi_auto_rates: bool = True
    fold_timit: bool = False


@dataclass
class GANConfig:
    """Adversarial objective of the unsupervised generator (same fields as
    ``uasr.config.GANConfig``): the WGAN-GP critic or wav2vec-U's bce
    objective, the optimizers, the output regularisers, label-free
    selection, the semi-supervised CTC mix-in and the segmental front."""

    objective: str = "wgan-gp"  # wgan-gp | bce
    lambda_gp: float = 10.0
    disc_steps: int = 3  # D updates per G update
    g_lr: float = 1e-4
    d_lr: float = 4e-4
    real_label_smooth: float = 0.0  # smooth real one-hot text toward uniform
    adam_b1: float = 0.5  # both GAN optimizers (b2 0.9)
    use_lr_schedule: bool = False  # train.lr_schedule's shape at g_lr / d_lr
    entropy_weight: float = 0.0  # push G's posteriors toward one-hot
    diversity_weight: float = 0.0  # entropy of the batch-mean posterior
    smoothness_weight: float = 0.0  # ||p_t - p_t+1||^2 on the pre-merge stream
    select_lm_path: str | None = None  # lm.npz from `prepare lm`
    select_kl_weight: float = 1.0
    select_coverage_weight: float = 1.0
    d_weight_decay: float = 0.0  # coupled L2 on the critic's gradient
    supervised_weight: float = 0.0  # semi-supervised CTC mix-in
    segmenter: str = "none"  # none | kmeans
    kmeans_clusters: int = 64
    centroids_path: str | None = None  # npz with 'centroids' [K, D]
    max_segments: int = 0  # 0 -> frame count (no cap)
    segment_mode_radius: int = 0  # >0: majority-vote de-flicker window
    merge_repeats: bool = False  # collapse equal-argmax runs before D / EODM
    segment_on_raw: bool = False  # quantize on the pre-CMVN feature view


@dataclass
class EODMConfig:
    """Empirical output-distribution matching (same fields as
    ``uasr.config.EODMConfig``)."""

    ngram_orders: tuple = (2, 3)
    top_k: int = 1000  # top-K n-grams per order
    weight: float = 1.0
    ngram_path: str | None = None  # precomputed table; else built from text
    k_chunk: int = 1024  # bounds the loss's peak to B * Tp * k_chunk


@dataclass
class DataConfig:
    train_list: str | None = None
    dev_list: str | None = None
    test_list: str | None = None
    feature_cache: str | None = None
    dev_feature_cache: str | None = None
    test_feature_cache: str | None = None
    labeled_list: str | None = None
    labeled_feature_cache: str | None = None
    synthetic_labeled_utts: int = 16
    max_frames: int = 1024
    text_path: str | None = None
    vocab_path: str | None = None
    batch_size: int = 16
    max_audio_seconds: float = 16.0
    max_label_len: int = 256
    bucket_boundaries: tuple = ()  # seconds; empty -> single bucket
    shuffle_buffer: int = 4096
    streaming: bool = True
    loader_threads: int = 0
    device_cache: bool = True
    synthetic: bool = False
    synthetic_num_utts: int = 128
    synthetic_dev_utts: int | None = None
    synthetic_style: str = "tone"
    synthetic_syntax: str = "iid"
    synthetic_min_len: int = 3
    synthetic_max_len: int = 10
    num_epochs: int | None = None


@dataclass
class TrainConfig:
    mode: str = "ctc"
    total_steps: int = 1000
    lr: float = 1e-3
    warmup_steps: int = 100
    lr_schedule: str = "warmup_exp_decay"
    decay_rate: float = 0.96
    decay_steps: int = 1000
    grad_clip: float = 5.0
    grad_accum: int = 1
    eval_every: int = 200
    save_every: int = 500
    log_every: int = 50
    keep_checkpoints: int = 5
    seed: int = 0
    dev_eval_batches: int = 50
    dev_full_length: bool = True
    tensorboard: bool = False
    keep_best: bool = False
    restore_best: bool = False
    average_checkpoints: int = 1


@dataclass
class ParallelConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel: int = 1


@dataclass
class Config:
    name: str = "default"
    model_dir: str = "exp/default"
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    ctc: CTCConfig = field(default_factory=CTCConfig)
    gan: GANConfig = field(default_factory=GANConfig)
    eodm: EODMConfig = field(default_factory=EODMConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    vocab_size: int | None = None

    @property
    def dim_output(self) -> int:
        """Vocab size including blank (reference: `dim_output`)."""
        if self.vocab_size is None:
            raise ValueError("vocab_size not set; load a vocab first")
        return self.vocab_size

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def load_config(path: str) -> Config:
    """Load a YAML recipe into a typed Config tree."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return _build(Config, raw)
