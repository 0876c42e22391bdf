"""CTC forced alignment: transcripts -> per-frame phone labels
(counterpart of ``uasr.tools.align``).

A trained CTC checkpoint Viterbi-aligns each utterance's transcript to its
frames (``uasr_torch.ops.viterbi.ctc_forced_align``, on ``--device``) and
the list is written back with the fourth column of per-10 ms-frame labels
that ``train.mode: frame_ce`` reads:

  python -m uasr_torch.tools.align -c ctc.yaml --split train \\
      --out exp/train_aligned.tsv [--batch 32] [--set model_dir=exp/ctc] [--device cpu]

The alignment is computed at the logits rate and upsampled by the total
stride (frontend downsample x encoder stride) back to 10 ms frames: the
inverse of the frame-CE trainer's ``labels[:, ::total]`` subsampling. On
CUDA the features and the BiGRU run through kernels K1 and K2; the
alignment itself is plain PyTorch on the card, as the JAX package runs it
outside any kernel.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def align_list(cfg, list_path: str, out_path: str, batch_size: int | None = None,
               device="cuda") -> dict:
    """Forced-align every utterance in ``list_path``; write ``out_path``
    with the alignment as the fourth column. Returns stats."""
    from uasr_torch import resolve_device
    from uasr_torch.cli import restore_trainer
    from uasr_torch.data.dataset import ASRDataset
    from uasr_torch.frontend.features import compute_features
    from uasr_torch.models.models import encoder_time_subsample
    from uasr_torch.ops.viterbi import ctc_forced_align
    from uasr_torch.vocab import load_vocab

    if cfg.train.mode not in ("ctc", "frame_ce"):
        raise SystemExit(
            "forced alignment needs a CTC-trained checkpoint "
            f"(train.mode is {cfg.train.mode!r}; align the selftrain/"
            "distilled student instead of a GAN generator)"
        )
    device = resolve_device(device)
    vocab = load_vocab(cfg.data.vocab_path)
    ds = ASRDataset.from_file(list_path, vocab, cfg.frontend.sample_rate)
    utts = ds.utts
    if not utts:
        raise SystemExit(f"{list_path}: empty list")
    B = batch_size or cfg.data.batch_size
    max_samples = int(cfg.data.max_audio_seconds * cfg.frontend.sample_rate)
    L = cfg.data.max_label_len
    total = cfg.frontend.downsample * encoder_time_subsample(cfg.model)

    # restore exactly as `--mode infer` would
    trainer, step = restore_trainer(cfg, device)
    model = trainer.model.eval()
    fstate = trainer.frontend_state
    print(f"align: restored step {step}", file=sys.stderr)

    lines = []
    n_frames = 0
    score_sum = 0.0
    for start in range(0, len(utts), B):
        chunk = list(range(start, min(start + B, len(utts))))
        nb = len(chunk)
        labels = np.zeros((nb, L), np.int64)
        llen = np.zeros(nb, np.int64)
        alen = np.zeros(nb, np.int64)
        pad_a = np.zeros((nb, max_samples), np.float32)
        for i, j in enumerate(chunk):
            audio, ids = ds.example(j)
            audio = audio[:max_samples]
            ids = ids[:L]
            pad_a[i, : len(audio)] = audio
            alen[i] = len(audio)
            labels[i, : len(ids)] = ids
            llen[i] = len(ids)
        with torch.inference_mode():
            audio_t = torch.as_tensor(pad_a, device=device)
            alen_t = torch.as_tensor(alen, device=device)
            logits, out_len = model(*compute_features(audio_t, alen_t, fstate, cfg.frontend))
            frame_ids, score = ctc_forced_align(
                logits, out_len, torch.as_tensor(labels, device=device),
                torch.as_tensor(llen, device=device), blank_id=cfg.ctc.blank_id)
        frame_ids = frame_ids.cpu().numpy()
        out_len = out_len.cpu().numpy()
        score = score.cpu().numpy()
        for i, j in enumerate(chunk):
            u = utts[j]
            T_i = int(out_len[i])
            # each logits-rate label repeated `total` times: the inverse of
            # the frame-CE trainer's labels[:, ::total]
            track = np.repeat(frame_ids[i, :T_i], total)
            toks = " ".join(vocab.tokens[k] for k in track)
            text = " ".join(u.tokens)
            lines.append(f"{u.utt_id}\t{u.wav_path}\t{text}\t{toks}")
            n_frames += len(track)
            score_sum += float(score[i])
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    stats = {
        "utts": len(lines),
        "frames": n_frames,
        "mean_logp_per_frame": score_sum / max(n_frames, 1),
    }
    print(
        f"align: wrote {stats['utts']} utterances -> {out_path} "
        f"(mean path logp/frame {stats['mean_logp_per_frame']:.3f})",
        file=sys.stderr,
    )
    return stats


def main(argv=None):
    p = argparse.ArgumentParser("uasr_torch.tools.align", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True, help="CTC recipe YAML")
    p.add_argument("--split", default="train", choices=["train", "dev", "test"],
                   help="which data.<split>_list to align")
    p.add_argument("--out", required=True, help="aligned list output path")
    p.add_argument("--batch", type=int, default=None,
                   help="override data.batch_size for alignment")
    p.add_argument("--set", action="append", default=[],
                   help="config override, e.g. --set model_dir=exp/ctc")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; raises without a card) or cpu (plain versions)")
    args = p.parse_args(argv)

    from uasr_torch.cli import apply_overrides
    from uasr_torch.config import load_config

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    if cfg.data.vocab_path is None:
        raise SystemExit("alignment needs data.vocab_path")
    if cfg.vocab_size is None:
        from uasr_torch.vocab import load_vocab

        cfg = cfg.replace(vocab_size=len(load_vocab(cfg.data.vocab_path)))
    list_path = getattr(cfg.data, f"{args.split}_list")
    if list_path is None:
        raise SystemExit(f"recipe has no data.{args.split}_list")
    align_list(cfg, list_path, args.out, batch_size=args.batch, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
