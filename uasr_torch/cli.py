"""CLI entry point of the port: ``python -m uasr_torch.cli -c recipe.yaml
--mode train|infer [--set key=value ...] [--device cuda|cpu]``
(counterpart of ``uasr.cli``).

``--mode train`` runs ``train.mode: ctc`` through ``run_ctc_training``,
``gan`` and ``gan+eodm`` through ``run_gan_training`` and ``eodm``
through ``run_eodm_training`` (the unpaired text from ``data.text_path``,
or the split's own transcripts), resuming from the newest checkpoint
under ``model_dir/ckpt``. ``--mode infer`` restores the newest
checkpoint (or the average of the newest ``train.average_checkpoints``,
or ``best_ckpt`` with ``train.restore_best``) and decodes the test split
with ``run_inference``; a GAN or EODM checkpoint decodes through the
chain it trained on (``GeneratorInfer.logits_fn``). ``--device``
defaults to ``cuda`` and raises without a card; ``--device cpu`` runs
the plain PyTorch versions of the kernels.
``--set`` casts each value to the field's type and rejects unknown keys.

Data: the synthetic corpora and materialised utterance lists. The
streaming loader and feature caches are not ported yet; ``frame_ce`` and
``ssl`` raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys


def _load_source(cfg, split: str):
    """(examples, vocab) of a split: the synthetic corpus (seed 0 for
    train, 1 for dev, 2 for test, so dev and test are held out) or a
    materialised utterance list."""
    from uasr_torch.data.dataset import ASRDataset, make_synthetic_dataset
    from uasr_torch.vocab import load_vocab

    cache_dir = {"train": cfg.data.feature_cache, "dev": cfg.data.dev_feature_cache,
                 "test": cfg.data.test_feature_cache,
                 "labeled": cfg.data.labeled_feature_cache}.get(split)
    if cache_dir:
        raise NotImplementedError(
            "data feature caches are not ported yet (ROADMAP.md Queue 1, item 10: SSL and "
            "feature caches)")
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
            style=cfg.data.synthetic_style,
        )
        if split == "labeled":
            # the semi-supervised mix-in's labeled split: a small paired
            # subset of the train corpus (seed 0)
            examples = examples[: cfg.data.synthetic_labeled_utts]
        return examples, vocab
    vocab = load_vocab(cfg.data.vocab_path)
    path = getattr(cfg.data, f"{split}_list")
    if path is None:
        raise SystemExit(f"recipe has no data.{split}_list")
    if cfg.data.streaming and split != "labeled":
        raise NotImplementedError(
            "data.streaming (the disk-backed loader, uasr/data/loader.py) is not ported yet "
            "(ROADMAP.md Queue 1); --set data.streaming=false reads the list into memory")
    ds = ASRDataset.from_file(path, vocab, cfg.frontend.sample_rate)
    return [ds.example(i) for i in range(len(ds))], vocab


def _batches(cfg, examples, num_epochs="cfg", seed=0, drop_remainder=True, limit=None):
    from uasr_torch.data.dataset import batch_iterator, prefetch

    if num_epochs == "cfg":
        num_epochs = cfg.data.num_epochs  # None = cycle forever
    sr = cfg.frontend.sample_rate
    it = batch_iterator(
        examples,
        batch_size=cfg.data.batch_size,
        max_audio_samples=int(cfg.data.max_audio_seconds * sr),
        max_label_len=cfg.data.max_label_len,
        seed=seed,
        drop_remainder=drop_remainder,
        num_epochs=num_epochs,
        bucket_boundaries=[int(s * sr) for s in cfg.data.bucket_boundaries],
    )
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


def _lift_caps_for_split(cfg, examples):
    """cfg with the data caps sized to the split's real maxima
    (train.dev_full_length): dev eval sees whole utterances; the recipe's
    bucket boundaries below the cap stay and the cap is the catch-all
    bucket."""
    max_sec, max_lab = cfg.data.max_audio_seconds, cfg.data.max_label_len
    for a, ids in examples:
        max_sec = max(max_sec, len(a) / cfg.frontend.sample_rate)
        max_lab = max(max_lab, len(ids))
    bounds = ()
    if cfg.data.bucket_boundaries:
        bounds = tuple(sorted(b for b in cfg.data.bucket_boundaries if b < max_sec)) + (max_sec,)
    return cfg.replace(data=dataclasses.replace(
        cfg.data, max_audio_seconds=max_sec, max_label_len=max_lab, bucket_boundaries=bounds))


def _dev_batches_fn(cfg):
    if cfg.data.dev_list is None and not cfg.data.synthetic:
        return None
    dev_examples, _ = _load_source(cfg, "dev")
    if cfg.train.dev_full_length:
        cfg = _lift_caps_for_split(cfg, dev_examples)

    def fn():
        return _batches(cfg, dev_examples, num_epochs=1, drop_remainder=False,
                        limit=cfg.train.dev_eval_batches)

    return fn


def _train_ctc(cfg, examples, device):
    from uasr_torch.train import run_ctc_training

    run_ctc_training(cfg, _batches(cfg, examples, seed=cfg.train.seed),
                     dev_batches_fn=_dev_batches_fn(cfg), device=device)
    return 0


def _load_text(cfg, examples, vocab):
    """The unpaired text corpus: ``data.text_path``, or the split's own
    transcripts (synthetic and smoke runs)."""
    from uasr_torch.data.dataset import TextDataset

    if cfg.data.text_path:
        return TextDataset.from_file(cfg.data.text_path, vocab).sequences
    return [ids for _, ids in examples if ids]


def _train_gan(cfg, examples, vocab, device, with_eodm=False):
    from uasr_torch.train import run_gan_training

    labeled = None
    if cfg.gan.supervised_weight > 0 and (cfg.data.labeled_list or cfg.data.synthetic):
        # the semi-supervised mix-in's own small paired stream, cycled; a
        # labeled set smaller than a batch wraps around to fill it
        ex, _ = _load_source(cfg, "labeled")
        if not ex:
            raise SystemExit("data.labeled_list is empty")
        while len(ex) < cfg.data.batch_size:
            ex = ex + ex
        labeled = _batches(cfg, ex, num_epochs=None, seed=cfg.train.seed + 1)
    run_gan_training(cfg, _batches(cfg, examples, seed=cfg.train.seed),
                     _load_text(cfg, examples, vocab), with_eodm=with_eodm,
                     dev_batches_fn=_dev_batches_fn(cfg), labeled_batches=labeled,
                     device=device)
    return 0


def _train_eodm(cfg, examples, vocab, device):
    from uasr_torch.train import run_eodm_training

    run_eodm_training(cfg, _batches(cfg, examples, seed=cfg.train.seed),
                      _load_text(cfg, examples, vocab), dev_batches_fn=_dev_batches_fn(cfg),
                      device=device)
    return 0


def restore_trainer(cfg, device):
    """(trainer, step): a trainer whose ``model`` holds the newest
    checkpoint under ``model_dir/ckpt`` (the average of the newest
    ``train.average_checkpoints``, or ``best_ckpt`` with
    ``train.restore_best``): a ``CTCTrainer``, or for ``train.mode`` gan,
    gan+eodm and eodm a ``GeneratorInfer`` holding the generator (a
    ``GANState``'s first tree). Exits when there is none."""
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

        trainer = GeneratorInfer(cfg, device=device)
        params = dict(trainer.gen.named_parameters())
        opt = make_optimizer(cfg)
        if mode == "eodm":
            template = TrainState(0, params, opt.init(params))
        else:
            dp = dict(build_discriminator(cfg.model, cfg.dim_output,
                                          device=trainer.device).named_parameters())
            template = GANState(0, params, dp, opt.init(params), opt.init(dp))
    else:
        trainer = CTCTrainer(cfg, device=device)
        template = trainer.init_state()
    if cfg.train.average_checkpoints > 1:
        restored = restore_averaged(mgr, template, cfg.train.average_checkpoints)
    else:
        restored = mgr.restore_latest(template)
    mgr.close()
    if restored is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir}")
    state, step = restored
    trainer.model.load_state_dict(state[1])
    return trainer, step


def _infer(cfg, examples, vocab, device):
    from uasr_torch.infer import run_inference

    trainer, step = restore_trainer(cfg, device)
    logits_fn = getattr(trainer, "logits_fn", None)
    res = run_inference(
        cfg, trainer.model, trainer.frontend_state,
        _batches(cfg, examples, num_epochs=1, drop_remainder=False),
        vocab=vocab, hyp_path=f"{cfg.model_dir}/hyp.txt", device=device, logits_fn=logits_fn,
    )
    avg = (f" (avg of last {cfg.train.average_checkpoints})"
           if cfg.train.average_checkpoints > 1 else "")
    print(f"step {step}{avg}: PER={res['per']:.4f} RTF={res['rtf']:.4f} "
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

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    device = resolve_device(args.device)
    mode = cfg.train.mode
    if mode == "frame_ce":
        raise NotImplementedError(
            "train.mode frame_ce is not ported yet (ROADMAP.md Queue 1, slice 3: frame-CE)")
    if mode == "ssl":
        raise NotImplementedError(
            "train.mode ssl is not ported yet (ROADMAP.md Queue 1, item 10: SSL and feature "
            "caches)")
    if mode not in ("ctc", "gan", "gan+eodm", "eodm"):
        raise SystemExit(f"unknown train.mode {mode!r}")
    examples, vocab = _load_source(cfg, "train" if args.mode == "train" else "test")
    if cfg.vocab_size is None:
        cfg = cfg.replace(vocab_size=len(vocab))
    print(f"device: {device}", file=sys.stderr)
    if args.mode == "infer":
        return _infer(cfg, examples, vocab, device)
    if mode in ("gan", "gan+eodm"):
        return _train_gan(cfg, examples, vocab, device, with_eodm="+eodm" in mode)
    if mode == "eodm":
        return _train_eodm(cfg, examples, vocab, device)
    return _train_ctc(cfg, examples, device)


if __name__ == "__main__":
    raise SystemExit(main())
