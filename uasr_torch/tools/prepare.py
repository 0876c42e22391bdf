"""Data preparation for unsupervised training (counterpart of the
``ngrams``, ``lm`` and ``kmeans`` subcommands of ``uasr.tools.prepare``):

  python -m uasr_torch.tools.prepare ngrams --text phones.txt --vocab vocab.txt \\
      --orders 2,3 --top-k 1000 --out ngrams.npz     # eodm.ngram_path
  python -m uasr_torch.tools.prepare lm --text phones.txt --vocab vocab.txt \\
      [--order 2|3] --out lm.npz                     # gan.select_lm_path
  python -m uasr_torch.tools.prepare kmeans --config recipe.yaml --list train.tsv \\
      --vocab vocab.txt --out kmeans.npz [--device cuda|cpu]   # gan.centroids_path

``kmeans`` fits the segmenter's centroids in the feature space the
trainer quantises in: the recipe's frontend (the raw pre-CMVN view with
``gan.segment_on_raw``). The other subcommands of the JAX tool are not
ported yet (ROADMAP.md Queue 1: ``import-arpa`` item 8; ``vocab``,
``lists``, ``scan-lengths``, ``cmvn`` and ``synth`` item 8a;
``import-features`` and ``export-kaldi`` item 10; ``import-ali`` item 6).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def _text(args):
    from uasr_torch.data.dataset import TextDataset
    from uasr_torch.vocab import load_vocab

    vocab = load_vocab(args.vocab)
    return vocab, TextDataset.from_file(args.text, vocab).sequences


def cmd_ngrams(args):
    from uasr_torch.ops.eodm import build_ngram_table, save_ngram_tables

    _, seqs = _text(args)
    tables = []
    for order in (int(o) for o in args.orders.split(",")):
        tables.append(build_ngram_table(seqs, order, args.top_k))
        print(f"order {order}: kept {len(tables[-1].ids)} n-grams")
    save_ngram_tables(args.out, tables)
    print(f"wrote n-gram tables -> {args.out}")


def cmd_lm(args):
    """Add-k n-gram LM (order 2 or 3) and unigram of the unpaired text,
    blank excluded."""
    from uasr_torch.ops.lm import build_bigram_lm, build_trigram_lm, build_unigram, save_lm
    from uasr_torch.vocab import BLK

    vocab, seqs = _text(args)
    blank = vocab.tokens.index(BLK) if BLK in vocab.tokens else 0
    build = {2: build_bigram_lm, 3: build_trigram_lm}[args.order]
    logp = build(seqs, len(vocab), add_k=args.add_k, exclude=(blank,))
    uni = build_unigram(seqs, len(vocab), add_k=args.add_k, exclude=(blank,))
    save_lm(args.out, logp, unigram=uni)
    print(f"wrote {args.order}-gram LM {list(logp.shape)} + unigram -> {args.out}")


def cmd_kmeans(args):
    """Centroids fitted on the frames of the first ``--max-utts``
    utterances of ``--list``, one utterance at a time through the
    recipe's frontend on ``--device``."""
    import torch

    from uasr_torch import resolve_device
    from uasr_torch.config import load_config
    from uasr_torch.data.dataset import ASRDataset
    from uasr_torch.frontend.features import compute_features, frontend_state_from_config
    from uasr_torch.ops.segment import kmeans_fit
    from uasr_torch.vocab import load_vocab

    cfg = load_config(args.config)
    clusters = args.clusters or cfg.gan.kmeans_clusters
    if args.feature_cache:
        raise NotImplementedError(
            "--feature-cache (data/cache.py feature caches) is not ported yet (ROADMAP.md "
            "Queue 1, item 10: SSL and feature caches)")
    if not args.list or not args.vocab:
        raise SystemExit("kmeans needs --list and --vocab")
    device = resolve_device(args.device)
    ds = ASRDataset.from_file(args.list, load_vocab(args.vocab), cfg.frontend.sample_rate)
    fcfg = cfg.frontend
    if cfg.gan.segment_on_raw:
        fcfg = dataclasses.replace(fcfg, cmvn="none")
    if args.cmvn_stats:
        fcfg = dataclasses.replace(fcfg, cmvn_stats_path=args.cmvn_stats)
    fe = frontend_state_from_config(fcfg, device=device)
    frames = []
    with torch.inference_mode():
        for i in range(min(len(ds), args.max_utts)):
            audio, _ = ds.example(i)
            f, fl = compute_features(torch.as_tensor(audio[None, :], device=device),
                                     torch.tensor([len(audio)], device=device), fe, fcfg)
            frames.append(f[0, : int(fl[0])].cpu().numpy())
    feats = np.concatenate(frames, axis=0).astype(np.float32)
    cents = kmeans_fit(feats, clusters, iters=args.iters, seed=args.seed)
    np.savez(args.out, centroids=cents)
    print(f"fit {clusters} centroids on {len(feats)} frames -> {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser("uasr_torch.tools.prepare", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    n = sub.add_parser("ngrams")
    n.add_argument("--text", required=True)
    n.add_argument("--vocab", required=True)
    n.add_argument("--orders", default="2,3")
    n.add_argument("--top-k", type=int, default=1000)
    n.add_argument("--out", required=True)
    n.set_defaults(fn=cmd_ngrams)

    lm = sub.add_parser("lm")
    lm.add_argument("--text", required=True)
    lm.add_argument("--vocab", required=True)
    lm.add_argument("--order", type=int, default=2, choices=[2, 3])
    lm.add_argument("--add-k", type=float, default=0.5)
    lm.add_argument("--out", required=True)
    lm.set_defaults(fn=cmd_lm)

    km = sub.add_parser("kmeans")
    km.add_argument("--list")
    km.add_argument("--vocab")
    km.add_argument("--feature-cache", default=None,
                    help="fit on cached SSL features (not ported yet)")
    km.add_argument("--config", required=True)
    km.add_argument("--clusters", type=int, default=0,
                    help="0 -> recipe's gan.kmeans_clusters")
    km.add_argument("--iters", type=int, default=25)
    km.add_argument("--max-utts", type=int, default=500)
    km.add_argument("--seed", type=int, default=0)
    km.add_argument("--cmvn-stats", default=None,
                    help="override frontend.cmvn_stats_path (for cmvn=global)")
    km.add_argument("--device", default="cuda",
                    help="cuda (K1; raises without a card) or cpu (its plain version)")
    km.add_argument("--out", required=True)
    km.set_defaults(fn=cmd_kmeans)

    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
