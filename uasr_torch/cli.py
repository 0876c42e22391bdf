"""CLI entry point of the port: ``python -m uasr_torch.cli -c recipe.yaml
--mode train|infer [--set key=value ...] [--device cuda|cpu]``
(counterpart of ``uasr.cli``).

``--mode train`` runs ``train.mode: ctc`` (and ``frame_ce``, frame-level
CE on the lists' fourth column of per-frame labels) through
``run_ctc_training``, ``gan`` and ``gan+eodm`` through ``run_gan_training`` and ``eodm``
through ``run_eodm_training`` (the unpaired text from ``data.text_path``,
or the split's own transcripts), and ``ssl`` (contrastive pretraining on
raw audio) through ``pretrain.run_ssl_pretraining``, resuming from the
newest checkpoint under ``model_dir/ckpt``. ``--mode infer`` restores the newest
checkpoint (or the average of the newest ``train.average_checkpoints``,
or ``best_ckpt`` with ``train.restore_best``) and decodes the test split
with ``run_inference`` (greedy, ``ctc.use_beam`` with an optional
``ctc.lm_path`` table, or ``ctc.use_viterbi`` over that table); a GAN or
EODM checkpoint decodes through the chain it trained on
(``GeneratorInfer.logits_fn``), for the Viterbi's rate probe too. ``--device``
defaults to ``cuda`` and raises without a card; ``--device cpu`` runs
the plain PyTorch versions of the kernels.
``--set`` casts each value to the field's type and rejects unknown keys.

Several devices: one process per device under torchrun (``torchrun
--nproc-per-node N -m uasr_torch.cli ...``). ``main`` joins the process
group (``parallel.init_distributed``: NCCL on the card, gloo with
``--device cpu``), takes ``cuda:LOCAL_RANK``, and
runs training and decode over the mesh of
``(N // parallel.model_parallel, parallel.model_parallel)``: every rank
reads the same batches and keeps its data-group rows, and rank 0 writes.

Data: the synthetic corpora, and utterance lists (``prepare lists`` or
``synth``) streamed from disk one batch at a time by
``data.loader.StreamingASRDataset`` (``data.streaming``, the default) or
read into memory (``--set data.streaming=false``). ``frame_ce`` reads its
train and dev splits into memory with their alignment tracks (the
synthetic corpora with theirs). A split with a feature cache
(``data.feature_cache``, ``data.{dev,test,labeled}_feature_cache``: the
``tools.featurize`` or ``prepare import-features`` dumps) gives [B, T, D]
feature batches that bypass the frontend: on one CUDA device with
``data.device_cache`` (the default) from the corpus uploaded to the card
once (``data.cache.device_feature_batches``), else read on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys

import numpy as np
import torch


def _load_source(cfg, split: str):
    """(source, vocab) of a split. The source is ``("examples", list)``:
    the synthetic corpus (seed 0 for train, 1 for dev, 2 for test, so dev
    and test are held out) or an utterance list read into memory;
    ``("stream", StreamingASRDataset)``: an utterance list under
    ``data.streaming``, decoded one batch at a time; or ``("features",
    FeatureCache)`` for a split with a feature cache. The labeled mix-in
    split is always read into memory, and so are ``frame_ce``'s train and
    dev splits, as (audio, ids, frame labels) triples: alignment tracks
    are consumed by the frame-CE step only, so the test split decodes
    plain examples."""
    from uasr_torch.data.dataset import ASRDataset, make_synthetic_dataset
    from uasr_torch.vocab import load_vocab

    cache_dir = {"train": cfg.data.feature_cache, "dev": cfg.data.dev_feature_cache,
                 "test": cfg.data.test_feature_cache,
                 "labeled": cfg.data.labeled_feature_cache}.get(split)
    if cache_dir:
        if cfg.train.mode == "frame_ce" and split != "test":
            raise SystemExit("train.mode=frame_ce needs per-frame alignments; feature caches "
                             "carry none")
        from uasr_torch.data.cache import FeatureCache

        if cfg.data.vocab_path is None:
            raise SystemExit(f"data.{'' if split == 'train' else split + '_'}feature_cache "
                             "needs data.vocab_path (tokens for text/scoring)")
        return ("features", FeatureCache(cache_dir)), load_vocab(cfg.data.vocab_path)
    aligned = cfg.train.mode == "frame_ce" and split != "test"
    if cfg.data.synthetic:
        n_utts = cfg.data.synthetic_num_utts
        if split in ("dev", "test") and cfg.data.synthetic_dev_utts:
            n_utts = cfg.data.synthetic_dev_utts
        examples, vocab = make_synthetic_dataset(
            num_utts=n_utts,
            num_phones=(cfg.vocab_size - 2) if cfg.vocab_size else 16,
            seed={"train": 0, "dev": 1, "test": 2}.get(split, 0),
            syntax=cfg.data.synthetic_syntax,
            min_len=cfg.data.synthetic_min_len,
            max_len=cfg.data.synthetic_max_len,
            with_alignments=aligned,
            style=cfg.data.synthetic_style,
        )
        if split == "labeled":
            # the semi-supervised mix-in's labeled split: a small paired
            # subset of the train corpus (seed 0)
            examples = examples[: cfg.data.synthetic_labeled_utts]
        return ("examples", examples), vocab
    vocab = load_vocab(cfg.data.vocab_path)
    path = getattr(cfg.data, f"{split}_list")
    if path is None:
        raise SystemExit(f"recipe has no data.{split}_list")
    if cfg.data.streaming and not aligned and split != "labeled":
        from uasr_torch.data.loader import StreamingASRDataset

        return ("stream", StreamingASRDataset.from_file(path, vocab,
                                                        cfg.frontend.sample_rate)), vocab
    if aligned:
        from uasr_torch.data.dataset import ASRAlignDataset

        ads = ASRAlignDataset.from_file(path, vocab, cfg.frontend.sample_rate)
        return ("examples", [ads.example_with_alignment(i) for i in range(len(ads))]), vocab
    ds = ASRDataset.from_file(path, vocab, cfg.frontend.sample_rate)
    return ("examples", [ds.example(i) for i in range(len(ds))]), vocab


def _batches(cfg, source, num_epochs="cfg", seed=0, drop_remainder=True, limit=None,
             device=None):
    """Prefetched batches of a source: bucketed ``Batch``es, or for (audio,
    ids, frame labels) triples ``AlignedBatch``es padded to the cap, their
    tracks to the cap's frame count. A feature cache gives [B, max_frames,
    D] batches, from the corpus resident on ``device`` when that is a CUDA
    device and ``data.device_cache`` is set, else read on the host.
    In-memory [T, D] feature examples (self-training over a cache) are
    batched up to ``data.max_frames`` without buckets."""
    from uasr_torch.data.dataset import aligned_batch_iterator, batch_iterator, prefetch

    if num_epochs == "cfg":
        num_epochs = cfg.data.num_epochs  # None = cycle forever
    sr = cfg.frontend.sample_rate
    kind, payload = source
    kw = dict(batch_size=cfg.data.batch_size,
              max_audio_samples=int(cfg.data.max_audio_seconds * sr),
              max_label_len=cfg.data.max_label_len, seed=seed, drop_remainder=drop_remainder,
              num_epochs=num_epochs,
              bucket_boundaries=[int(s * sr) for s in cfg.data.bucket_boundaries])
    if kind == "features":
        from uasr_torch.data.cache import device_feature_batches, feature_batch_iterator

        fkw = dict(batch_size=cfg.data.batch_size, max_frames=cfg.data.max_frames,
                   max_label_len=cfg.data.max_label_len, seed=seed, num_epochs=num_epochs,
                   drop_remainder=drop_remainder)
        if cfg.data.device_cache and device is not None and torch.device(device).type == "cuda":
            it = device_feature_batches(payload, device=device, **fkw)
        else:
            it = feature_batch_iterator(payload, **fkw)
    elif kind == "stream":
        it = payload.batches(shuffle_buffer=cfg.data.shuffle_buffer,
                             decode_threads=cfg.data.loader_threads, **kw)
    elif payload and np.ndim(payload[0][0]) == 2:
        it = batch_iterator(payload, **dict(kw, max_audio_samples=cfg.data.max_frames,
                                            bucket_boundaries=()))
    elif payload and len(payload[0]) == 3:
        fl, fs = cfg.frontend.frame_length, cfg.frontend.frame_shift
        del kw["bucket_boundaries"]
        it = aligned_batch_iterator(payload, max_frames=max(1 + (kw["max_audio_samples"] - fl)
                                                            // fs, 1), **kw)
    else:
        it = batch_iterator(payload, **kw)
    if limit is not None:
        # cap before prefetch so the worker ends instead of being abandoned
        it = itertools.islice(it, limit)
    return prefetch(it)


def apply_overrides(cfg, overrides: list[str]) -> None:
    """Apply ``key.path=value`` overrides in place, casting to the field's
    current type (bool/int/float/str, and comma-split sequences for
    tuple/list fields, e.g. ``--set data.bucket_boundaries=2,4,8``)."""
    for ov in overrides:
        if "=" not in ov:
            raise SystemExit(f"--set expects key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        parts = key.split(".")
        obj = cfg
        try:
            for part in parts[:-1]:
                obj = getattr(obj, part)
            cur = getattr(obj, parts[-1])
        except AttributeError:
            raise SystemExit(f"--set {key}: no such config field") from None
        cast = type(cur) if cur is not None else _hint_cast(obj, parts[-1])
        try:
            if val.lower() in ("none", "null") and (
                cur is None or type(None) in _hint_args(obj, parts[-1])
            ):
                # only Optional-annotated fields: 'none' is a legitimate
                # string value elsewhere (e.g. frontend.cmvn=none)
                val = None
            elif cast is bool:
                val = val.lower() in ("1", "true", "yes")
            elif cast in (int, float):
                val = cast(val)
            elif cast in (tuple, list):
                val = cast(_scalar(v) for v in val.split(",") if v.strip())
        except ValueError:
            raise SystemExit(f"--set {key}: cannot parse {val!r} as {cast.__name__}") from None
        object.__setattr__(obj, parts[-1], val)


def _hint_args(obj, field: str) -> tuple:
    """Resolved members of the field's type annotation (union-flattened)."""
    import typing

    try:
        ann = typing.get_type_hints(type(obj)).get(field)
    except Exception:
        return ()
    return typing.get_args(ann) or (ann,)


def _hint_cast(obj, field: str):
    """Cast for a field whose current value is None: the first non-None
    member of its annotation (``int | None`` fields get int)."""
    for t in _hint_args(obj, field):
        if t is not type(None) and t in (bool, int, float, str, tuple, list):
            return t
    return str


def _scalar(s: str):
    """Best-effort element cast for --set sequence values."""
    s = s.strip()
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            return s


def _lift_caps_for_split(cfg, source):
    """cfg with the data caps sized to the split's real maxima
    (train.dev_full_length): dev eval sees whole utterances; the recipe's
    bucket boundaries below the cap stay and the cap is the catch-all
    bucket. A stream's maxima come from its scanned lengths and encoded
    labels, so nothing is decoded; a feature cache lifts
    ``data.max_frames``."""
    max_sec, max_lab = cfg.data.max_audio_seconds, cfg.data.max_label_len
    max_frames = cfg.data.max_frames
    kind, payload = source
    if kind == "features":
        for _, f, ids in payload:
            max_frames = max(max_frames, len(f))
            max_lab = max(max_lab, len(ids))
    elif kind == "stream":
        if len(payload):
            max_sec = max(max_sec, float(max(payload.num_samples)) / cfg.frontend.sample_rate)
            max_lab = max(max_lab, max(len(ids) for ids in payload.labels))
    else:
        for a, ids, *_ in payload:
            max_sec = max(max_sec, len(a) / cfg.frontend.sample_rate)
            max_lab = max(max_lab, len(ids))
    bounds = ()
    if cfg.data.bucket_boundaries:
        bounds = tuple(sorted(b for b in cfg.data.bucket_boundaries if b < max_sec)) + (max_sec,)
    return cfg.replace(data=dataclasses.replace(
        cfg.data, max_frames=max_frames, max_audio_seconds=max_sec, max_label_len=max_lab,
        bucket_boundaries=bounds))


def _dev_batches_fn(cfg, device=None):
    if (cfg.data.dev_list is None and cfg.data.dev_feature_cache is None
            and not cfg.data.synthetic):
        return None
    dev_source, _ = _load_source(cfg, "dev")
    if cfg.train.dev_full_length:
        cfg = _lift_caps_for_split(cfg, dev_source)

    def fn():
        return _batches(cfg, dev_source, num_epochs=1, drop_remainder=False,
                        limit=cfg.train.dev_eval_batches, device=device)

    return fn


def _train_ctc(cfg, source, device, mesh=None):
    from uasr_torch.train import run_ctc_training

    run_ctc_training(cfg, _batches(cfg, source, seed=cfg.train.seed, device=device),
                     dev_batches_fn=_dev_batches_fn(cfg, device), device=device, mesh=mesh)
    return 0


def _train_ssl(cfg, source, device, mesh=None):
    """Contrastive pretraining over raw audio; ``tools.featurize`` then
    dumps the features the unsupervised stage trains on."""
    from uasr_torch.pretrain import run_ssl_pretraining

    if source[0] == "features":
        raise SystemExit("train.mode=ssl pretrains on RAW AUDIO; the split already has a "
                         "feature cache configured")
    run_ssl_pretraining(cfg, _batches(cfg, source, seed=cfg.train.seed),
                        dev_batches_fn=_dev_batches_fn(cfg), device=device, mesh=mesh)
    return 0


def _load_text(cfg, source, vocab):
    """The unpaired text corpus: ``data.text_path``, or the split's own
    transcripts (synthetic and smoke runs)."""
    from uasr_torch.data.dataset import TextDataset

    if cfg.data.text_path:
        return TextDataset.from_file(cfg.data.text_path, vocab).sequences
    kind, payload = source
    if kind == "stream":
        return [ids for ids in payload.labels if ids]
    if kind == "features":
        return [list(ids) for _, _, ids in payload if len(ids)]
    return [ids for _, ids in payload if ids]


def _train_gan(cfg, source, vocab, device, with_eodm=False, mesh=None):
    from uasr_torch.train import run_gan_training

    labeled = None
    if cfg.gan.supervised_weight > 0 and (cfg.data.labeled_list or cfg.data.labeled_feature_cache
                                          or cfg.data.synthetic):
        # the semi-supervised mix-in's own small paired stream, cycled; a
        # labeled set smaller than a batch wraps around to fill it
        lab_source, _ = _load_source(cfg, "labeled")
        if lab_source[0] == "examples":
            ex = list(lab_source[1])
            if not ex:
                raise SystemExit("data.labeled_list is empty")
            while len(ex) < cfg.data.batch_size:
                ex = ex + ex
            lab_source = ("examples", ex)
        labeled = _batches(cfg, lab_source, num_epochs=None, seed=cfg.train.seed + 1,
                           device=device)
    run_gan_training(cfg, _batches(cfg, source, seed=cfg.train.seed, device=device),
                     _load_text(cfg, source, vocab), with_eodm=with_eodm,
                     dev_batches_fn=_dev_batches_fn(cfg, device), labeled_batches=labeled,
                     device=device, mesh=mesh)
    return 0


def _train_eodm(cfg, source, vocab, device, mesh=None):
    from uasr_torch.train import run_eodm_training

    run_eodm_training(cfg, _batches(cfg, source, seed=cfg.train.seed, device=device),
                      _load_text(cfg, source, vocab),
                      dev_batches_fn=_dev_batches_fn(cfg, device), device=device, mesh=mesh)
    return 0


def restore_trainer(cfg, device, mesh=None):
    """(trainer, step): a trainer whose ``model`` holds the newest
    checkpoint under ``model_dir/ckpt`` (the average of the newest
    ``train.average_checkpoints``, or ``best_ckpt`` with
    ``train.restore_best``): a ``CTCTrainer``, for ``train.mode`` gan,
    gan+eodm and eodm a ``GeneratorInfer`` holding the generator (a
    ``GANState``'s first tree), or for ``ssl`` an ``SSLTrainer`` holding the
    ``CPCModel`` (``tools.featurize``). Exits when there is none. Over
    ``mesh`` the model holds this rank's shards of the whole tensors the
    checkpoint keeps."""
    from uasr_torch.checkpoint import CheckpointManager, restore_averaged
    from uasr_torch.train import CTCTrainer, GANState, GeneratorInfer, TrainState, make_optimizer

    ckpt_dir = f"{cfg.model_dir}/ckpt"
    if cfg.train.restore_best:
        ckpt_dir = f"{cfg.model_dir}/best_ckpt"
        if not os.path.isdir(ckpt_dir):
            raise SystemExit(f"train.restore_best: no {ckpt_dir} — was the run trained with "
                             "train.keep_best (dev PER) or gan.select_lm_path (label-free "
                             "selection)?")
    mgr = CheckpointManager(ckpt_dir, max_to_keep=cfg.train.keep_checkpoints)
    mode = cfg.train.mode
    if mode in ("gan", "gan+eodm", "eodm"):
        from uasr_torch.models.models import build_discriminator

        trainer = GeneratorInfer(cfg, device=device, mesh=mesh)
        params = dict(trainer.gen.named_parameters())
        opt = make_optimizer(cfg)
        if mode == "eodm":
            template = TrainState(0, params, opt.init(params))
        else:
            dp = dict(build_discriminator(cfg.model, cfg.dim_output,
                                          device=trainer.device).named_parameters())
            template = GANState(0, params, dp, opt.init(params), opt.init(dp))
    elif mode == "ssl":
        from uasr_torch.pretrain import SSLTrainer

        trainer = SSLTrainer(cfg, device=device, mesh=mesh)
        template = trainer.init_state()
    else:
        trainer = CTCTrainer(cfg, device=device, mesh=mesh)
        template = trainer.init_state()
    template = trainer.whole_state(template)
    if cfg.train.average_checkpoints > 1:
        restored = restore_averaged(mgr, template, cfg.train.average_checkpoints)
    else:
        restored = mgr.restore_latest(template)
    mgr.close()
    if restored is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir}")
    state, step = restored
    plan = trainer.plans[0]
    trainer.model.load_state_dict(state[1] if plan is None else plan.shard(state[1]))
    return trainer, step


def _infer(cfg, source, vocab, device, mesh=None):
    from uasr_torch.infer import run_inference

    if cfg.train.mode == "ssl":
        raise SystemExit("ssl checkpoints have no decode path; dump features with `python -m "
                         "uasr_torch.tools.featurize` and train/infer a downstream recipe on "
                         "the cache")
    trainer, step = restore_trainer(cfg, device, mesh)
    logits_fn = getattr(trainer, "logits_fn", None)
    # a feature cache bypasses the frontend, whose state (global CMVN
    # statistics, say) the recipe then need not provide
    fstate = None if source[0] == "features" else trainer.frontend_state
    res = run_inference(
        cfg, trainer.model, fstate,
        _batches(cfg, source, num_epochs=1, drop_remainder=False, device=device),
        vocab=vocab, hyp_path=f"{cfg.model_dir}/hyp.txt", device=device, logits_fn=logits_fn,
        fold_timit=cfg.ctc.fold_timit, mesh=mesh,
    )
    folded = f" PER_folded={res['per_folded']:.4f}" if "per_folded" in res else ""
    avg = (f" (avg of last {cfg.train.average_checkpoints})"
           if cfg.train.average_checkpoints > 1 else "")
    if mesh is not None and not mesh.is_writer:
        return 0
    print(f"step {step}{avg}: PER={res['per']:.4f}{folded} RTF={res['rtf']:.4f} "
          f"({res['audio_seconds']:.1f}s audio)")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser("uasr_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True, help="YAML recipe")
    p.add_argument("--mode", default="train", choices=["train", "infer"],
                   help="train, or restore the newest checkpoint and decode")
    p.add_argument("--set", action="append", default=[],
                   help="override, e.g. --set train.total_steps=100")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; raises without a card) or cpu (plain versions)")
    args = p.parse_args(argv)

    from uasr_torch import resolve_device
    from uasr_torch.config import load_config
    from uasr_torch.parallel import init_distributed, local_device, make_mesh

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    mesh = None
    if init_distributed(args.device):
        device = resolve_device(local_device(args.device))
        mesh = make_mesh(cfg.parallel.model_parallel, device.type)
    else:
        device = resolve_device(args.device)
    mode = cfg.train.mode
    if mode not in ("ctc", "frame_ce", "gan", "gan+eodm", "eodm", "ssl"):
        raise SystemExit(f"unknown train.mode {mode!r}")
    source, vocab = _load_source(cfg, "train" if args.mode == "train" else "test")
    if cfg.vocab_size is None:
        cfg = cfg.replace(vocab_size=len(vocab))
    print(f"device: {device}" + (f" {mesh}" if mesh is not None else ""), file=sys.stderr)
    if args.mode == "infer":
        return _infer(cfg, source, vocab, device, mesh)
    if mode in ("gan", "gan+eodm"):
        return _train_gan(cfg, source, vocab, device, with_eodm="+eodm" in mode, mesh=mesh)
    if mode == "eodm":
        return _train_eodm(cfg, source, vocab, device, mesh)
    if mode == "ssl":
        return _train_ssl(cfg, source, device, mesh)
    return _train_ctc(cfg, source, device, mesh)


if __name__ == "__main__":
    raise SystemExit(main())
