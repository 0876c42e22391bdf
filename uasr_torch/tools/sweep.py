"""Multi-seed unsupervised training with label-free selection (counterpart
of ``uasr.tools.sweep``):

  python -m uasr_torch.tools.sweep -c recipe.yaml --seeds 4 [--set k=v ...] \\
      [--device cuda|cpu]

Adversarial phone mapping is basin-sensitive: the same features and
settings land at very different PERs depending on the seed, so the
protocol trains several seeds and picks the winner without labels. Seed
N trains into ``<model_dir>/seed<N>`` with ``train.seed = N`` (resumable:
a finished seed restores its final checkpoint and trains no step). The
recipe (``train.mode`` gan or gan+eodm) must set ``gan.select_lm_path``
and have a dev split, so each run keeps ``seed<N>/best_ckpt`` and its
``score.json`` (mean LM token log-prob minus the usage KL of the dev
transcriptions). The sweep reads the scores, writes
``<model_dir>/sweep.json`` and prints the winner, which decodes with
``--mode infer --set model_dir=<winner> --set train.restore_best=true``
and seeds ``tools.selftrain --restore-best``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser("uasr_torch.tools.sweep", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True,
                   help="YAML recipe (train.mode gan or gan+eodm, gan.select_lm_path set)")
    p.add_argument("--seeds", type=int, default=3, help="number of seeds (train.seed = 0..N-1)")
    p.add_argument("--set", action="append", default=[],
                   help="config override, e.g. --set train.total_steps=2000")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; raises without a card) or cpu (plain versions)")
    args = p.parse_args(argv)

    from uasr_torch import resolve_device
    from uasr_torch.cli import _load_source, _train_gan, apply_overrides
    from uasr_torch.config import load_config

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    if cfg.train.mode not in ("gan", "gan+eodm"):
        raise SystemExit("tools.sweep is the unsupervised multi-seed protocol (train.mode "
                         f"gan/gan+eodm), got {cfg.train.mode!r}")
    if not cfg.gan.select_lm_path:
        raise SystemExit("tools.sweep selects without labels via gan.select_lm_path — build one "
                         "with `prepare lm` (or import-arpa) from the unpaired text and set it "
                         "in the recipe")
    device = resolve_device(args.device)
    source, vocab = _load_source(cfg, "train")
    if cfg.vocab_size is None:
        cfg = cfg.replace(vocab_size=len(vocab))
    print(f"device: {device}", file=sys.stderr)

    root = cfg.model_dir
    results = []
    for seed in range(args.seeds):
        seed_dir = os.path.join(root, f"seed{seed}")
        cfg_s = cfg.replace(model_dir=seed_dir, train=dataclasses.replace(cfg.train, seed=seed))
        score_path = os.path.join(seed_dir, "best_ckpt", "score.json")
        print(f"[sweep] seed {seed} -> {seed_dir}", file=sys.stderr)
        # run_gan_training restores the newest checkpoint, so a finished
        # seed trains no step
        _train_gan(cfg_s, source, vocab, device, with_eodm="+eodm" in cfg.train.mode)
        if not os.path.exists(score_path):
            raise SystemExit(f"seed {seed} finished without {score_path} — did the run ever "
                             "reach train.eval_every with a dev split?")
        with open(score_path) as f:
            rec = json.load(f)
        results.append({"seed": seed, "model_dir": seed_dir, "score": rec["score"],
                        "step": rec["step"]})
        print(f"[sweep] seed {seed}: unsup_score {rec['score']:.4f} at step {rec['step']}",
              file=sys.stderr)

    results.sort(key=lambda r: r["score"], reverse=True)
    out = {"winner": results[0], "ranking": results,
           "selection": "label-free (mean LM token log-prob - usage-KL)"}
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "sweep.json"), "w") as f:
        json.dump(out, f, indent=1)
    w = results[0]
    print(f"[sweep] winner: seed {w['seed']} (score {w['score']:.4f}, step {w['step']}) — "
          f"decode with --set model_dir={w['model_dir']} --set train.restore_best=true",
          file=sys.stderr)
    print(json.dumps(out["winner"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
