"""Data preparation (counterpart of ``uasr.tools.prepare``; each output
file equals the JAX command's byte for byte, ``cmvn``'s arrays to float
rounding):

  python -m uasr_torch.tools.prepare vocab --text phones.txt --out vocab.txt [--has-utt-ids]
  python -m uasr_torch.tools.prepare lists --wav-scp wav.scp --text text \\
      --out train.tsv [--no-lens]           # also writes the train.tsv.lens sidecar
  python -m uasr_torch.tools.prepare scan-lengths --list train.tsv   # the .lens sidecar
  python -m uasr_torch.tools.prepare cmvn --list train.tsv --vocab vocab.txt \\
      --config recipe.yaml --out cmvn.npz    # frontend.cmvn_stats_path
  python -m uasr_torch.tools.prepare synth --out-dir data/synth --num-utts 128 \\
      [--num-phones 16 --seed 0 --syntax iid|markov --style tone|formant --align]
  python -m uasr_torch.tools.prepare import-ali --ali ali.ark|ali.scp --list train.tsv \\
      --vocab vocab.txt [--phone-map phones.txt] --out train_aligned.tsv
  python -m uasr_torch.tools.prepare ngrams --text phones.txt --vocab vocab.txt \\
      --orders 2,3 --top-k 1000 --out ngrams.npz     # eodm.ngram_path
  python -m uasr_torch.tools.prepare lm --text phones.txt --vocab vocab.txt \\
      [--order 2|3] --out lm.npz          # ctc.lm_path, gan.select_lm_path
  python -m uasr_torch.tools.prepare import-arpa --arpa lm.arpa --vocab vocab.txt \\
      [--order 2|3] --out lm.npz          # an ARPA (KenLM/SRILM) LM as the same table
  python -m uasr_torch.tools.prepare kmeans --config recipe.yaml --list train.tsv \\
      --vocab vocab.txt --out kmeans.npz [--device cuda|cpu]   # gan.centroids_path
  python -m uasr_torch.tools.prepare kmeans --config recipe.yaml \\
      --feature-cache cache/ --out kmeans.npz      # in a feature cache's space
  python -m uasr_torch.tools.prepare import-features --features feats/|feats.npz|feats.scp \\
      --list train.tsv [--vocab vocab.txt] --out cache/      # data.feature_cache
  python -m uasr_torch.tools.prepare export-kaldi --feature-cache cache/ --out feats

``kmeans`` fits the segmenter's centroids in the feature space the
trainer quantises in: the recipe's frontend (the raw pre-CMVN view with
``gan.segment_on_raw``). ``lists`` joins Kaldi-style wav.scp (utt_id
wav_path) and text (utt_id tokens...) into the TSV utterance lists the
datasets read; ``synth`` writes the synthetic corpus to disk (wavs,
``train.tsv`` / ``dev.tsv`` with their sidecars, ``vocab.txt``,
``text.txt``; with ``--align`` a fourth column of per-frame phone labels).
``import-ali`` merges Kaldi per-frame phone alignments into a list as that
fourth column, which ``train.mode: frame_ce`` reads. ``kmeans
--feature-cache`` fits on a feature cache's frames, the arrays a recipe
with ``data.feature_cache`` quantises. ``import-features`` writes
externally computed features (a directory of ``<utt_id>.npy`` [T, D], one
``.npz`` keyed by utterance id, or a Kaldi ``feats.scp`` / ``.ark``,
compressed matrices included) into a feature cache, the labels from the
list's transcripts; ``export-kaldi`` writes a cache as a binary ``FM``
ark + scp.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def cmd_vocab(args):
    from uasr_torch.vocab import BLK, UNK

    counts: dict[str, int] = {}
    with open(args.text) as f:
        for ln in f:
            toks = ln.split()
            if args.has_utt_ids:
                toks = toks[1:]
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
    tokens = [BLK] + sorted(counts, key=lambda t: (-counts[t], t)) + [UNK]
    with open(args.out, "w") as f:
        f.write("\n".join(tokens) + "\n")
    print(f"wrote {len(tokens)} tokens -> {args.out}")


def cmd_lists(args):
    from uasr_torch.data.loader import write_length_sidecar

    wavs: dict[str, str] = {}
    with open(args.wav_scp) as f:
        for ln in f:
            parts = ln.split(maxsplit=1)
            if len(parts) == 2:
                wavs[parts[0]] = parts[1].strip()
    texts: dict[str, str] = {}
    if args.text:
        with open(args.text) as f:
            for ln in f:
                parts = ln.split(maxsplit=1)
                texts[parts[0]] = parts[1].strip() if len(parts) == 2 else ""
    with open(args.out, "w") as f:
        for utt, wav in sorted(wavs.items()):
            f.write(f"{utt}\t{wav}\t{texts.get(utt, '')}\n")
    print(f"wrote {len(wavs)} utterances -> {args.out}")
    if not args.no_lens:
        print(f"wrote length cache -> {write_length_sidecar(args.out)}")


def cmd_scan_lengths(args):
    """The ``<list>.lens`` length cache of an existing utterance list: one
    header scan now, no file opened at later starts of the streaming
    loader."""
    from uasr_torch.data.loader import write_length_sidecar

    print(f"wrote length cache -> {write_length_sidecar(args.list, scan_threads=args.threads)}")


def cmd_cmvn(args):
    from uasr_torch.config import load_config
    from uasr_torch.data.dataset import ASRDataset, compute_cmvn_stats
    from uasr_torch.vocab import load_vocab

    cfg = load_config(args.config)
    ds = ASRDataset.from_file(args.list, load_vocab(args.vocab), cfg.frontend.sample_rate)
    mean, std = compute_cmvn_stats([ds.example(i) for i in range(len(ds))], cfg.frontend)
    np.savez(args.out, mean=mean, std=std)
    print(f"wrote CMVN stats ({mean.shape[0]} dims) -> {args.out}")


def cmd_synth(args):
    from uasr_torch.data.dataset import make_synthetic_dataset
    from uasr_torch.data.io import write_wav
    from uasr_torch.data.loader import write_length_sidecar

    examples, vocab = make_synthetic_dataset(
        num_utts=args.num_utts, num_phones=args.num_phones, seed=args.seed,
        with_alignments=args.align, syntax=args.syntax, style=args.style,
        min_len=args.min_len, max_len=args.max_len,
    )
    wav_dir = os.path.join(args.out_dir, "wav")
    lines = []
    for i, (audio, ids, *align) in enumerate(examples):
        path = os.path.join(wav_dir, f"utt{i:05d}.wav")
        write_wav(path, audio, 16000)
        line = f"utt{i:05d}\t{path}\t{' '.join(vocab.tokens[j] for j in ids)}"
        if align:  # 4th column: per-10 ms-frame phone labels
            line += "\t" + " ".join(vocab.tokens[j] for j in align[0])
        lines.append(line)
    n_dev = max(args.num_utts // 8, 1)
    for split, part in (("train.tsv", lines[n_dev:]), ("dev.tsv", lines[:n_dev])):
        with open(os.path.join(args.out_dir, split), "w") as f:
            f.write("\n".join(part) + "\n")
        write_length_sidecar(os.path.join(args.out_dir, split))
    with open(os.path.join(args.out_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(vocab.tokens) + "\n")
    with open(os.path.join(args.out_dir, "text.txt"), "w") as f:
        f.write("\n".join(" ".join(vocab.tokens[j] for j in ex[1]) for ex in examples) + "\n")
    print(f"wrote {args.num_utts} wavs + lists + vocab -> {args.out_dir}")


def cmd_import_ali(args):
    """Merge Kaldi per-frame alignments (``ali-to-phones --per-frame``
    output, ark or scp) into an utterance list as the fourth column that
    ``train.mode: frame_ce`` reads. Frame ids map to symbols through
    ``--phone-map`` (Kaldi phones.txt, '<symbol> <id>' lines); without it
    they index the ``--vocab`` table."""
    from uasr_torch.data.kaldi import iter_ali
    from uasr_torch.vocab import load_vocab

    vocab = load_vocab(args.vocab)
    if args.phone_map:
        id2sym = {}
        with open(args.phone_map) as f:
            for ln in f:
                parts = ln.split()
                if len(parts) >= 2:
                    id2sym[int(parts[1])] = parts[0]
    else:
        id2sym = dict(enumerate(vocab.tokens))
    ali = {}
    for utt, ids in iter_ali(args.ali):
        try:
            ali[utt] = " ".join(id2sym[int(i)] for i in ids)
        except KeyError as e:
            raise SystemExit(f"{utt}: alignment id {e.args[0]} has no symbol (wrong "
                             "--phone-map? alignments must be per-frame phone ids, not "
                             "transition-ids)") from None
    out_lines = []
    with open(args.list) as f:
        for ln in f:
            parts = ln.rstrip("\n").split("\t")
            if not parts or not parts[0]:
                continue
            if parts[0] not in ali:
                raise SystemExit(f"no alignment for list utterance {parts[0]!r}")
            out_lines.append("\t".join(parts[:3]) + "\t" + ali[parts[0]])
    with open(args.out, "w") as f:
        f.write("\n".join(out_lines) + "\n")
    print(f"wrote {len(out_lines)} aligned utterances -> {args.out}")


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


def cmd_import_arpa(args):
    """An ARPA n-gram LM as the dense decode table ``ctc.lm_path`` and
    ``gan.select_lm_path`` read (row V = '<s>'), blank column excluded."""
    from uasr_torch.ops.lm import load_arpa, save_lm
    from uasr_torch.vocab import BLK, load_vocab

    vocab = load_vocab(args.vocab)
    blank = vocab.tokens.index(BLK) if BLK in vocab.tokens else 0
    logp, uni = load_arpa(args.arpa, vocab.tokens, order=args.order, exclude=(blank,))
    save_lm(args.out, logp, unigram=uni)
    print(f"imported ARPA {args.arpa} -> {list(logp.shape)} decode table + unigram -> "
          f"{args.out}")


def cmd_kmeans(args):
    """Centroids fitted on the frames of the first ``--max-utts``
    utterances of ``--list``, one utterance at a time through the
    recipe's frontend on ``--device``, or of ``--feature-cache``."""
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
        from uasr_torch.data.cache import FeatureCache

        cache = FeatureCache(args.feature_cache)
        frames = [cache.example(i)[1] for i in range(min(len(cache), args.max_utts))]
        feats = np.concatenate(frames, axis=0).astype(np.float32)
        cents = kmeans_fit(feats, clusters, iters=args.iters, seed=args.seed)
        np.savez(args.out, centroids=cents)
        print(f"fit {clusters} centroids on {len(feats)} cached frames -> {args.out}")
        return
    if not args.list or not args.vocab:
        raise SystemExit("kmeans needs --list and --vocab (or --feature-cache)")
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


def cmd_import_features(args):
    """Externally computed features into a feature cache (the utterances
    and transcripts of the TSV list, encoded with ``--vocab`` when given)."""
    from uasr_torch.data.cache import write_cache
    from uasr_torch.vocab import load_vocab

    vocab = load_vocab(args.vocab) if args.vocab else None
    utts: list[tuple[str, str]] = []
    with open(args.list) as f:
        for ln in f:
            parts = ln.rstrip("\n").split("\t")
            if parts and parts[0]:
                utts.append((parts[0], parts[2] if len(parts) > 2 else ""))

    if args.features.endswith((".scp", ".ark")):
        from uasr_torch.data import kaldi

        text = dict(utts)
        it = (kaldi.iter_feats_scp(args.features) if args.features.endswith(".scp")
              else kaldi.iter_feats_ark(args.features))

        def gen_kaldi():
            seen = set()
            for utt, feat in it:
                if utt not in text:
                    continue  # the table may cover more splits than the list
                seen.add(utt)
                yield utt, feat, vocab.encode(text[utt].split()) if (vocab and text[utt]) else []
            missing = [u for u, _ in utts if u not in seen]
            if missing:
                raise SystemExit(f"{len(missing)} list utterances absent from {args.features} "
                                 f"(first: {missing[0]!r})")

        write_cache(args.out, gen_kaldi(), shard_size=args.shard_size)
        print(f"imported kaldi features for {len(utts)} utterances -> {args.out}")
        return

    npz = np.load(args.features) if os.path.isfile(args.features) else None

    def gen():
        for utt, txt in utts:
            if npz is not None:
                if utt not in npz.files:
                    raise SystemExit(f"--features npz has no array for utterance {utt!r}")
                feat = npz[utt]
            else:
                path = os.path.join(args.features, f"{utt}.npy")
                if not os.path.exists(path):
                    raise SystemExit(f"missing feature file {path}")
                feat = np.load(path)
            if feat.ndim != 2:
                raise SystemExit(f"features for {utt!r} must be [T, D], got {feat.shape}")
            yield utt, feat, vocab.encode(txt.split()) if (vocab and txt) else []

    write_cache(args.out, gen(), shard_size=args.shard_size)
    print(f"imported features for {len(utts)} utterances -> {args.out}")


def cmd_export_kaldi(args):
    """A feature cache as a Kaldi feats table (binary ``FM`` ark + scp)."""
    from uasr_torch.data.cache import FeatureCache
    from uasr_torch.data.kaldi import write_feats_ark

    cache = FeatureCache(args.feature_cache)
    ark, scp = write_feats_ark(args.out, ((utt, feat) for utt, feat, _ in cache))
    print(f"wrote {len(cache)} utterances -> {ark} / {scp}")


def main(argv=None):
    p = argparse.ArgumentParser("uasr_torch.tools.prepare", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    v = sub.add_parser("vocab")
    v.add_argument("--text", required=True)
    v.add_argument("--out", required=True)
    v.add_argument("--has-utt-ids", action="store_true")
    v.set_defaults(fn=cmd_vocab)

    ls = sub.add_parser("lists")
    ls.add_argument("--wav-scp", required=True)
    ls.add_argument("--text")
    ls.add_argument("--out", required=True)
    ls.add_argument("--no-lens", action="store_true",
                    help="skip writing the <out>.lens length cache")
    ls.set_defaults(fn=cmd_lists)

    sl = sub.add_parser("scan-lengths")
    sl.add_argument("--list", required=True)
    sl.add_argument("--threads", type=int, default=16)
    sl.set_defaults(fn=cmd_scan_lengths)

    c = sub.add_parser("cmvn")
    c.add_argument("--list", required=True)
    c.add_argument("--vocab", required=True)
    c.add_argument("--config", required=True)
    c.add_argument("--out", required=True)
    c.set_defaults(fn=cmd_cmvn)

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

    ia = sub.add_parser("import-arpa",
                        help="ARPA n-gram LM (KenLM/SRILM) -> dense decode table npz")
    ia.add_argument("--arpa", required=True)
    ia.add_argument("--vocab", required=True)
    ia.add_argument("--order", type=int, default=None, choices=[2, 3],
                    help="default: highest available order, capped at 3")
    ia.add_argument("--out", required=True)
    ia.set_defaults(fn=cmd_import_arpa)

    km = sub.add_parser("kmeans")
    km.add_argument("--list")
    km.add_argument("--vocab")
    km.add_argument("--feature-cache", default=None,
                    help="fit on cached SSL features instead of the frontend chain "
                         "(--list/--vocab unused)")
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

    imp = sub.add_parser("import-features")
    imp.add_argument("--features", required=True,
                     help="directory of <utt_id>.npy [T, D] files, one .npz keyed by utterance "
                          "id, or a Kaldi feats.scp/.ark table")
    imp.add_argument("--list", required=True,
                     help="TSV utterance list (utt_id\\twav\\ttranscript)")
    imp.add_argument("--vocab", default=None,
                     help="token table for encoding transcripts (omit for fully-unsupervised "
                          "caches)")
    imp.add_argument("--shard-size", type=int, default=512)
    imp.add_argument("--out", required=True)
    imp.set_defaults(fn=cmd_import_features)

    ek = sub.add_parser("export-kaldi")
    ek.add_argument("--feature-cache", required=True)
    ek.add_argument("--out", required=True,
                    help="output base path (writes <out>.ark + <out>.scp)")
    ek.set_defaults(fn=cmd_export_kaldi)

    ial = sub.add_parser("import-ali")
    ial.add_argument("--ali", required=True,
                     help="Kaldi per-frame phone alignments (.ark or .scp)")
    ial.add_argument("--list", required=True,
                     help="TSV utterance list to merge the 4th column into")
    ial.add_argument("--vocab", required=True)
    ial.add_argument("--phone-map", default=None,
                     help="Kaldi phones.txt mapping '<symbol> <id>'")
    ial.add_argument("--out", required=True)
    ial.set_defaults(fn=cmd_import_ali)

    s = sub.add_parser("synth")
    s.add_argument("--out-dir", required=True)
    s.add_argument("--num-utts", type=int, default=128)
    s.add_argument("--num-phones", type=int, default=16)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--align", action="store_true",
                   help="write a 4th column of per-frame phone labels (forced-alignment "
                        "track for train.mode=frame_ce)")
    s.add_argument("--syntax", choices=["iid", "markov"], default="iid",
                   help="markov = phonotactic grammar (needed for unsupervised identifiability)")
    s.add_argument("--style", choices=["tone", "formant"], default="tone",
                   help="formant = narrowband-noise formants with speaker and channel variation")
    s.add_argument("--min-len", type=int, default=3, help="min phones per utterance")
    s.add_argument("--max-len", type=int, default=10, help="max phones per utterance")
    s.set_defaults(fn=cmd_synth)

    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
