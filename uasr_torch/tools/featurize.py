"""Dump SSL features from a pretrained CPC checkpoint into the feature
cache (counterpart of ``uasr.tools.featurize``):

  python -m uasr_torch.cli -c pretrain.yaml --mode train           # train.mode ssl
  python -m uasr_torch.tools.featurize -c pretrain.yaml --split train \\
      --out exp/feats/train [--cmvn] [--pca 512] [--pool-kmeans 128] \\
      [--transforms-from DIR] [--layer context|latents] [--device cuda|cpu]
  # then point the unsupervised recipe's data.feature_cache at the dump

Restores the newest checkpoint under ``model_dir/ckpt`` and runs
``SSLTrainer.encode`` (the log-mel frontend first with ``ssl.input_type:
fbank``; the context GRU through K5 on the card with
``ssl.context_pallas``) on ``--device`` (default cuda; raises without a
card). The dump holds ``ssl.feature_layer`` ("context": the causal GRU's
outputs, "latents": the conv encoder's); the transcripts riding in the
source batches are kept, so downstream scoring and the fallback text work.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch


def dump_features(cfg, source, out_dir: str, layer: str | None = None, cmvn: bool = False,
                  pca_dim: int | None = None, pool_clusters: int | None = None,
                  transforms_from: str | None = None, sample_frames: int = 200_000,
                  device="cuda") -> int:
    """Run the restored CPC model over a split and write the cache; returns
    the number of utterances written.

    ``cmvn`` standardises each utterance's features (zero mean, unit
    variance per dimension): the cache path bypasses the frontend's CMVN.
    ``pca_dim`` and ``pool_clusters`` are the wav2vec-U prep: a PCA
    projection, then mean-pooling of adjacent frames with equal k-means
    ids. Fitting streams two passes over the split (O(D^2) memory; the
    k-means on a reservoir of ``sample_frames``), and the fitted
    transforms are saved beside the cache (``pca.npz``,
    ``pool_kmeans.npz``); ``transforms_from=<train dump>`` reuses them for
    dev and test splits."""
    from uasr_torch.cli import _batches, restore_trainer
    from uasr_torch.data import transforms as T
    from uasr_torch.data.cache import write_cache
    from uasr_torch.ops.segment import kmeans_fit

    layer = layer or cfg.ssl.feature_layer
    if layer not in ("context", "latents"):
        raise SystemExit(f"unknown feature layer {layer!r}")
    needs_fit = transforms_from is None and bool(pca_dim or pool_clusters)

    def make_batches():
        return _batches(cfg, source, num_epochs=1, drop_remainder=False)

    trainer, step = restore_trainer(cfg.replace(train=dataclasses.replace(
        cfg.train, average_checkpoints=1, restore_best=False)), device)
    print(f"featurize: restored step {step}", file=sys.stderr)
    trainer.model.eval()

    def raw_examples(batch_iter):
        n = 0
        for b in batch_iter:
            db = trainer.to_device(b[:2])
            with torch.inference_mode():
                z, c, _preds, flen = trainer.encode(None, db[0], db[1])
            feats = (c if layer == "context" else z).float().cpu().numpy()
            flen = flen.cpu().numpy()
            labels, llen = np.asarray(b[2]), np.asarray(b[3])
            for j in range(feats.shape[0]):
                f = feats[j, : int(flen[j])]
                if cmvn:
                    f = (f - f.mean(0, keepdims=True)) / (f.std(0, keepdims=True) + 1e-5)
                yield f"utt{n:08d}", f, list(labels[j][: int(llen[j])])
                n += 1

    pca = km = None
    if transforms_from is not None:
        pca, km = T.load_transforms(transforms_from)
        if pca_dim and pca is None:
            raise SystemExit(f"--pca given but no {T.PCA_FILE} under {transforms_from}")
        if pool_clusters and km is None:
            raise SystemExit(f"--pool-kmeans given but no {T.KMEANS_FILE} under "
                             f"{transforms_from}")
    elif needs_fit:
        # the fit pass: streaming PCA moments and a uniform frame reservoir
        # for the pooling k-means, both O(1) in the corpus length
        acc = T.StreamingPCA() if pca_dim else None
        res = T.Reservoir(sample_frames, seed=0) if pool_clusters else None
        for _, f, _ in raw_examples(make_batches()):
            if acc is not None:
                acc.update(f)
            if res is not None:
                res.update(f)
        os.makedirs(out_dir, exist_ok=True)
        if acc is not None:
            pca = acc.finalize(pca_dim)
            pca.save(os.path.join(out_dir, T.PCA_FILE))
            print(f"featurize: PCA fit on {acc.n} frames -> {pca_dim} dims", file=sys.stderr)
        if res is not None:
            sample = res.sample()
            if pca is not None:
                sample = pca(sample)
            km = kmeans_fit(sample, pool_clusters)
            T.save_kmeans(os.path.join(out_dir, T.KMEANS_FILE), km)
            print(f"featurize: pooling k-means fit on {len(sample)} frames -> "
                  f"{pool_clusters} clusters", file=sys.stderr)

    def transformed():
        for uid, f, ids in raw_examples(make_batches()):
            if pca is not None:
                f = pca(f)
            if km is not None:
                f = T.pool_adjacent(f, T.assign_clusters(f, km))
            yield uid, f, ids

    count = 0

    def counted():
        nonlocal count
        for ex in transformed():
            count += 1
            yield ex

    write_cache(out_dir, counted())
    print(f"featurize: wrote {count} utts -> {out_dir}", file=sys.stderr)
    return count


def main(argv=None):
    p = argparse.ArgumentParser("uasr_torch.tools.featurize", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True, help="pretraining YAML")
    p.add_argument("--split", default="train", choices=["train", "dev", "test"])
    p.add_argument("--out", required=True, help="cache output directory")
    p.add_argument("--layer", default=None, choices=["context", "latents"],
                   help="override ssl.feature_layer")
    p.add_argument("--cmvn", action="store_true",
                   help="standardise each utterance's features (the cache path bypasses the "
                        "frontend's CMVN; the unsupervised GAN wants normalised inputs)")
    p.add_argument("--pca", type=int, default=None, metavar="DIM",
                   help="fit (streaming) and apply a PCA projection to DIM dims")
    p.add_argument("--pool-kmeans", type=int, default=None, metavar="K",
                   help="fit k-means with K clusters (on a frame reservoir, after any PCA) and "
                        "mean-pool adjacent frames with equal cluster id")
    p.add_argument("--transforms-from", default=None, metavar="DIR",
                   help="reuse the PCA / k-means fitted by a previous dump (point dev/test at "
                        "the train dump) instead of refitting")
    p.add_argument("--sample-frames", type=int, default=200_000,
                   help="reservoir size for the k-means fit")
    p.add_argument("--set", action="append", default=[],
                   help="config override, e.g. --set model_dir=exp/ssl")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; raises without a card) or cpu (plain versions)")
    args = p.parse_args(argv)

    from uasr_torch import resolve_device
    from uasr_torch.cli import _load_source, apply_overrides
    from uasr_torch.config import load_config

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    device = resolve_device(args.device)
    source, vocab = _load_source(cfg, args.split)
    if cfg.vocab_size is None:
        cfg = cfg.replace(vocab_size=len(vocab))
    dump_features(cfg, source, args.out, layer=args.layer, cmvn=args.cmvn, pca_dim=args.pca,
                  pool_clusters=args.pool_kmeans, transforms_from=args.transforms_from,
                  sample_frames=args.sample_frames, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
