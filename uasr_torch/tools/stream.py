"""Online streaming transcription from the command line (counterpart of
``uasr.tools.stream``).

Restores a trained CTC checkpoint (or a GAN / EODM generator's: the
``classifier``, with the merged-stream collapse under
``gan.merge_repeats``) and transcribes a list of utterances as an online
service would: audio fed in fixed chunks, tokens emitted
incrementally, the final transcript equal to the offline ``--mode infer``
decode:

  python -m uasr_torch.tools.stream -c recipe.yaml [--list data/test.tsv] \\
      [--chunk-frames 64] [--batch 8] [--verbose] [--device cuda|cpu]

Requires ``frontend.cmvn: streaming`` and a streamable encoder: ``cnn``
or ``classifier`` (window replay, one chunk of latency), ``uni_gru``
(carried recurrent state, no right-context latency) or ``lc_bigru``
(carried state, ``num_gru_layers`` chunks of latency, chunks of
``lc_chunk`` patches).
Mixed-length batches are safe: per-utterance lengths go to the
recognizer, so decoding freezes at each utterance's own end. With
``--verbose`` the partial transcript is printed after every chunk; the
final lines are ``utt_id<TAB>tokens``, plus a PER summary when the list
carries references. With ``ctc.use_beam`` the partials are provisional
greedy and the final lines carry the complete beam transcript.
``--device`` defaults to ``cuda`` (kernels K7 and K4, and K5 for
``lc_bigru``) and raises without a card; ``--device cpu`` runs their
plain versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def _edit_distance(hyp: list, ref: list) -> int:
    """One hyp/ref pair through the port's batched edit distance."""
    from uasr_torch.ops.edit_distance import batch_edit_distance

    t = lambda x: torch.tensor([x or [0]], dtype=torch.long)  # noqa: E731
    n = lambda x: torch.tensor([len(x)], dtype=torch.long)  # noqa: E731
    return int(batch_edit_distance(t(ref), n(ref), t(hyp), n(hyp))[0])


def stream_list(cfg, model, utts, vocab, chunk_frames=None, batch=8, verbose=False,
                out=sys.stdout, device="cuda"):
    """utts: list of (utt_id, audio [np float32], ref_ids or None). Streams
    them in batches through ``StreamingRecognizer(cfg, model)``; returns
    (hyps dict, per or None)."""
    from uasr_torch.serve import StreamingRecognizer

    rec = StreamingRecognizer(cfg, model, chunk_frames=chunk_frames, device=device)
    cs = rec.chunk_samples
    hyps: dict[str, list[int]] = {}
    errs = total = 0
    for s in range(0, len(utts), batch):
        group = utts[s : s + batch]
        B = len(group)
        L = -(-max(len(a) for _, a, _ in group) // cs) * cs
        audio = np.zeros((B, L), np.float32)
        lens = np.zeros((B,), np.int64)
        for b, (_, a, _) in enumerate(group):
            audio[b, : len(a)] = a
            lens[b] = len(a)
        # per-utterance lengths: batch zero-padding is never decoded
        st = rec.init(B, audio_lengths=lens)
        got: list[list[int]] = [[] for _ in range(B)]

        def collect(ids, counts):
            ids, counts = ids.cpu().numpy(), counts.cpu().numpy()
            for b in range(B):
                got[b].extend(int(x) for x in ids[b, : counts[b]])

        for off in range(0, L, cs):
            st, ids, counts = rec.step(st, audio[:, off : off + cs])
            collect(ids, counts)
            if verbose:
                for b, (uid, _, _) in enumerate(group):
                    toks = " ".join(vocab.tokens[t] for t in got[b])
                    print(f"  [{uid} @ {off + cs} samples] {toks}", file=sys.stderr)
        _, ids, counts = rec.finish(st)
        if rec.use_beam:
            # the partials were provisional greedy; finish() carries the
            # complete beam transcript
            got = [[] for _ in range(B)]
            collect(ids, counts)
            for b, (uid, _, _) in enumerate(group):
                if len(got[b]) >= rec.max_tokens:
                    print(f"WARNING: {uid}: transcript hit the {rec.max_tokens}-token "
                          "beam-prefix cap (data.max_label_len) and was truncated",
                          file=sys.stderr)
        else:
            collect(ids, counts)
        for b, (uid, _, ref) in enumerate(group):
            hyps[uid] = got[b]
            print(f"{uid}\t{' '.join(vocab.tokens[t] for t in got[b])}", file=out)
            if ref is not None:
                errs += _edit_distance(got[b], list(ref))
                total += len(ref)
    return hyps, (errs / total if total else None)


def main(argv=None):
    from uasr_torch import resolve_device
    from uasr_torch.cli import _load_source, apply_overrides, restore_trainer
    from uasr_torch.config import load_config

    p = argparse.ArgumentParser("uasr_torch.tools.stream", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--list", help="TSV list to stream (default: the recipe's data.test_list "
                                  "or its synthetic test split)")
    p.add_argument("--chunk-frames", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-utts", type=int, default=None)
    p.add_argument("--verbose", action="store_true",
                   help="print the partial transcript after every chunk")
    p.add_argument("--set", action="append", default=[], dest="overrides")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; raises without a card) or cpu (plain versions)")
    args = p.parse_args(argv)

    cfg = load_config(args.config)
    apply_overrides(cfg, args.overrides)
    if args.list:
        cfg.data.test_list = args.list
    # the tool reads the list into memory (small serving sets)
    cfg.data.streaming = False
    device = resolve_device(args.device)
    (_, examples), vocab = _load_source(cfg, "test")
    if cfg.vocab_size is None:
        cfg = cfg.replace(vocab_size=len(vocab))
    names = None
    lst = args.list or cfg.data.test_list
    if not cfg.data.synthetic and lst:
        from uasr_torch.data.io import read_utterance_list

        names = [u.utt_id for u in read_utterance_list(lst)]
    utts = [((names[i] if names else f"utt{i:05d}"), np.asarray(a, np.float32), ids or None)
            for i, (a, ids) in enumerate(examples)]
    if args.max_utts:
        utts = utts[: args.max_utts]
    trainer, step = restore_trainer(cfg, device)
    print(f"stream: restored step {step}", file=sys.stderr)
    _, per = stream_list(cfg, trainer.model, utts, vocab, chunk_frames=args.chunk_frames,
                         batch=args.batch, verbose=args.verbose, device=device)
    if per is not None:
        print(f"PER={per:.4f} over {len(utts)} utterances", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
