"""Self-training CLI, the wav2vec-U refinement stage (counterpart of
``uasr.tools.selftrain``):

  python -m uasr_torch.tools.selftrain -c recipe.yaml \\
      --teacher-dir exp/timit_unsup --teacher-mode gan|eodm|ctc \\
      --rounds 2 --conf-threshold 0.5 [--restore-best] [--init-from-teacher] \\
      [--align-pseudo-labels] [--gold-list gold.tsv] [--student-steps N] \\
      [--no-full-length] [--set k=v ...] [--device cuda|cpu]

Restores the teacher (a GAN / EODM generator or a CTC model) from
``--teacher-dir`` (``--restore-best``: its ``best_ckpt``, the label-free
selected snapshot of a ``tools.sweep`` winner), pseudo-labels the
recipe's training audio (greedy, or with ``ctc.use_viterbi`` over
``ctc.lm_path`` the LM-HMM Viterbi path with its rates calibrated on the
teacher; ``--align-pseudo-labels`` forced-aligns each transcript for a
frame-CE student), trains a student per round under
``<model_dir>/selftrain_r<r>`` (each student labels the next round), then
reports teacher and student PER on the dev split. ``--device`` defaults
to ``cuda`` (the kernels; raises without a card); ``cpu`` runs the plain
versions. Under torchrun the students train over the mesh: every rank
holds the whole teacher and labels every batch (the labels are the same
everywhere), round 0's teacher weights are rank 0's, and rank 0 writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import itertools
import json
import os
import shutil
import sys

import torch


def _build_hmm(cfg, probe_logits, probe_batches, device):
    """The CTC-topology LM-HMM decoder for Viterbi pseudo-labelling, its
    dwell and blank rates calibrated on the teacher's greedy path over the
    probe batches (``ctc.viterbi_auto_rates``; rates set away from their
    defaults are kept)."""
    from uasr_torch.ops.lm import load_lm
    from uasr_torch.ops.viterbi import make_lm_decoder, resolve_viterbi_rates

    sl, bp, how = resolve_viterbi_rates(cfg.ctc, probe_logits, probe_batches)
    print(f"selftrain: Viterbi rates {how}: self_loop={sl:.3f} blank_prob={bp:.3f}",
          file=sys.stderr)
    dec = make_lm_decoder(load_lm(cfg.ctc.lm_path), cfg.ctc.blank_id, self_loop=sl,
                          blank_prob=bp, device=device)
    print("selftrain: Viterbi-LM pseudo-labeling enabled", file=sys.stderr)
    return dec


def _invalidate_stale_students(cfg, teacher_ckpt_dir: str, teacher_step: int,
                               teacher_mode: str, conf_threshold: float,
                               init_from_teacher: bool, gold_list: str | None,
                               align_pseudo_labels: bool = False) -> None:
    """Wipe the ``selftrain_r*`` students when the labelling settings
    changed since they were trained: a new teacher or teacher step, mode,
    threshold, init, gold list, alignment flag or student config. Otherwise
    a finished student would resume, train 0 steps and be reported as
    trained on the new labels. Equal settings keep resume intact;
    ``--rounds`` and ``--student-steps`` stay out of the digest, since
    growing either resumes the students legitimately."""
    meta = {
        "teacher": os.path.abspath(teacher_ckpt_dir),
        "teacher_step": teacher_step,
        "teacher_mode": teacher_mode,
        "conf_threshold": conf_threshold,
        "init_from_teacher": bool(init_from_teacher),
        "gold_list": gold_list,
        "align_pseudo_labels": bool(align_pseudo_labels),
        "config": dataclasses.asdict(cfg.replace(model_dir="")),
    }
    digest = hashlib.sha256(json.dumps(meta, sort_keys=True, default=str).encode()).hexdigest()
    meta_path = os.path.join(cfg.model_dir, "selftrain_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            old = json.load(f).get("digest")
        if old != digest:
            stale = sorted(glob.glob(os.path.join(cfg.model_dir, "selftrain_r*")))
            for d in stale:
                shutil.rmtree(d, ignore_errors=True)
            if stale:
                print("selftrain: labeling settings changed since the existing students were "
                      f"trained — wiped {stale} (they held pseudo-labels from the old "
                      "settings)", file=sys.stderr)
    os.makedirs(cfg.model_dir, exist_ok=True)
    with open(meta_path, "w") as f:
        json.dump({"digest": digest, "meta": meta}, f, indent=1, default=str)


def _materialize(cfg, source):
    """The train split as (audio, ids) examples in memory, or (feats [T, D],
    ids) from a feature cache: self-training rereads the corpus every
    round."""
    from uasr_torch.cli import _batches

    kind, payload = source
    if kind == "examples":
        return [ex[:2] for ex in payload]
    if kind == "features":
        return [(f, list(ids)) for _, f, ids in payload]
    return [(b.audio[i, : b.audio_lengths[i]], b.labels[i, : b.label_lengths[i]].tolist())
            for b in _batches(cfg, source, num_epochs=1, drop_remainder=False)
            for i in range(len(b.audio_lengths))]


def _restore_teacher(cfg, teacher_dir: str, teacher_mode: str, restore_best: bool, device):
    """(trainer whose ``model`` holds the teacher, step, checkpoint dir),
    restored with the templates ``cli.restore_trainer`` uses: a GAN's
    ``GANState`` or an EODM ``TrainState`` into a ``GeneratorInfer`` (the
    generator is a ``classifier`` whatever the student recipe's encoder),
    a CTC model's ``TrainState`` into a ``CTCTrainer`` of the recipe's
    model."""
    from uasr_torch.cli import restore_trainer

    ckpt_dir = f"{teacher_dir}/best_ckpt" if restore_best else f"{teacher_dir}/ckpt"
    tcfg = cfg.replace(model_dir=teacher_dir, train=dataclasses.replace(
        cfg.train, mode=teacher_mode, restore_best=restore_best, average_checkpoints=1))
    trainer, step = restore_trainer(tcfg, device)
    return trainer, step, ckpt_dir


def run_selftrain(cfg, teacher_dir: str, teacher_mode: str = "gan", rounds: int = 1,
                  conf_threshold: float = 0.0, student_steps: int | None = None,
                  gold_list: str | None = None, restore_best: bool = False,
                  init_from_teacher: bool = False, full_length: bool = True,
                  align_pseudo_labels: bool = False, device="cuda", mesh=None) -> dict:
    """Pseudo-label cfg's train split with the teacher under
    ``teacher_dir`` and train the students. Returns ``{"teacher_per",
    "student_per", "history", "student_dir"}``.

    ``init_from_teacher`` fine-tunes round 0 from the teacher's weights
    (the student keeps the teacher's architecture: ``model.encoder:
    classifier`` for a GAN / EODM teacher). ``full_length`` (default) lifts
    ``data.max_audio_seconds`` to the corpus maximum, so a recipe trained
    on short windows does not truncate the utterances being labelled,
    trained on and scored (``data.max_frames`` for a feature cache)."""
    from uasr_torch import resolve_device
    from uasr_torch.cli import _batches, _load_source
    from uasr_torch.selftrain import make_ctc_label_fn, make_gan_label_fn, self_train

    device = resolve_device(device)
    if cfg.ctc.use_viterbi and not cfg.ctc.lm_path:
        raise SystemExit("ctc.use_viterbi needs ctc.lm_path (bigram)")
    source, vocab = _load_source(cfg, "train")
    if cfg.vocab_size is None:
        cfg = cfg.replace(vocab_size=len(vocab))
    examples = _materialize(cfg, source)
    if full_length and examples and source[0] == "features":
        max_t = max(len(f) for f, _ in examples)
        if cfg.data.max_frames < max_t:
            print(f"selftrain: lifting data.max_frames {cfg.data.max_frames} -> {max_t} so "
                  "labeling/training/eval see whole utterances (--no-full-length keeps the "
                  "recipe's cap)", file=sys.stderr)
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, max_frames=max_t))
    elif full_length and examples:
        max_s = max(len(a) for a, _ in examples)
        if int(cfg.data.max_audio_seconds * cfg.frontend.sample_rate) < max_s:
            secs = max_s / cfg.frontend.sample_rate
            print(f"selftrain: lifting data.max_audio_seconds {cfg.data.max_audio_seconds} -> "
                  f"{secs:.2f} (--no-full-length keeps the recipe's cap)", file=sys.stderr)
            cfg = cfg.replace(data=dataclasses.replace(cfg.data, max_audio_seconds=secs))

    teacher, step, ckpt_dir = _restore_teacher(cfg, teacher_dir, teacher_mode, restore_best,
                                               device)
    probe = list(itertools.islice(_batches(cfg, ("examples", examples), num_epochs=1), 4))
    if teacher_mode in ("gan", "eodm"):
        def probe_logits(b):
            db = teacher.to_device(b)
            with torch.no_grad():
                _, _, _, n, logits = teacher._gen_probs_full(None, db[0], db[1])
            return logits, n

        label_maker = lambda hmm: make_gan_label_fn(  # noqa: E731
            teacher, hmm=hmm, align_frames=align_pseudo_labels)
        teacher_eval = lambda batches: teacher.evaluate_per(None, batches)  # noqa: E731
    else:
        params = dict(teacher.model.named_parameters())

        def probe_logits(b):
            teacher.model.eval()
            db = teacher.to_device(b)
            with torch.no_grad():
                return teacher.model(*teacher._feats(db[0], db[1]))

        label_maker = lambda hmm: make_ctc_label_fn(  # noqa: E731
            teacher, hmm=hmm, align_frames=align_pseudo_labels)
        teacher_eval = lambda batches: teacher.evaluate(params, batches)  # noqa: E731
    print(f"teacher restored from {ckpt_dir} (step {step})", file=sys.stderr)
    hmm = _build_hmm(cfg, probe_logits, probe, device) if cfg.ctc.use_viterbi else None
    label_fn = label_maker(hmm)

    if mesh is None or mesh.is_writer:
        _invalidate_stale_students(cfg, ckpt_dir, int(step), teacher_mode, conf_threshold,
                                   init_from_teacher, gold_list, align_pseudo_labels)
    if mesh is not None:
        mesh.barrier()

    def dev_batches_fn():
        dev_source, _ = _load_source(cfg, "dev")
        return _batches(cfg, dev_source, num_epochs=1, drop_remainder=False, device=device)

    has_dev = (cfg.data.synthetic or cfg.data.dev_list is not None
               or cfg.data.dev_feature_cache is not None)
    teacher_per = teacher_eval(dev_batches_fn()) if has_dev else float("nan")

    gold = []
    if gold_list:
        from uasr_torch.data.dataset import ASRDataset

        gds = ASRDataset.from_file(gold_list, vocab, cfg.frontend.sample_rate)
        gold = [gds.example(i) for i in range(len(gds))]

    init_params = None
    if init_from_teacher:
        if teacher_mode in ("gan", "eodm") and cfg.model.encoder != "classifier":
            raise SystemExit(
                "--init-from-teacher with a GAN/EODM teacher needs the student to keep "
                "model.encoder=classifier (the teacher generator's architecture), got "
                f"{cfg.model.encoder!r}")
        init_params = {k: v.detach().clone() for k, v in teacher.model.state_dict().items()}
        print("selftrain: student initialized from the teacher", file=sys.stderr)

    trainer, st_state, history = self_train(
        cfg, label_fn, examples, rounds=rounds, conf_threshold=conf_threshold,
        steps_per_round=student_steps, gold=gold, init_params=init_params, device=device,
        mesh=mesh, log=print if mesh is None or mesh.is_writer else (lambda *_: None))
    student_per = (trainer.evaluate(st_state.params, dev_batches_fn()) if has_dev
                   else float("nan"))
    return {
        "teacher_per": float(teacher_per),
        "student_per": float(student_per),
        "history": history,
        "student_dir": f"{cfg.model_dir}/selftrain_r{rounds - 1}",
    }


def main(argv=None):
    p = argparse.ArgumentParser("uasr_torch.tools.selftrain", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--teacher-dir", required=True)
    p.add_argument("--teacher-mode", default="gan", choices=["gan", "eodm", "ctc"])
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--conf-threshold", type=float, default=0.0)
    p.add_argument("--student-steps", type=int, default=None)
    p.add_argument("--gold-list", default=None,
                   help="labeled utterances mixed into every student round")
    p.add_argument("--restore-best", action="store_true",
                   help="restore <teacher-dir>/best_ckpt (the label-free selected snapshot, "
                        "e.g. a tools.sweep winner) instead of the latest checkpoint")
    p.add_argument("--init-from-teacher", action="store_true",
                   help="fine-tune the first student round from the teacher's weights instead "
                        "of from scratch (student must keep the teacher's architecture)")
    p.add_argument("--align-pseudo-labels", action="store_true",
                   help="forced-align each pseudo-label transcript against the teacher's frame "
                        "posteriors and train the student with per-frame CE "
                        "(train.mode=frame_ce) instead of CTC")
    p.add_argument("--no-full-length", action="store_true",
                   help="keep the recipe's data.max_audio_seconds cap instead of lifting it "
                        "to the corpus maximum")
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; raises without a card) or cpu (plain versions)")
    args = p.parse_args(argv)

    from uasr_torch.cli import apply_overrides
    from uasr_torch.config import load_config
    from uasr_torch.parallel import init_distributed, local_device, make_mesh

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    device, mesh = args.device, None
    if init_distributed(args.device):
        device = local_device(args.device)
        mesh = make_mesh(cfg.parallel.model_parallel, device.type)
    res = run_selftrain(
        cfg, args.teacher_dir, teacher_mode=args.teacher_mode, rounds=args.rounds,
        conf_threshold=args.conf_threshold, student_steps=args.student_steps,
        gold_list=args.gold_list, restore_best=args.restore_best,
        init_from_teacher=args.init_from_teacher, full_length=not args.no_full_length,
        align_pseudo_labels=args.align_pseudo_labels, device=device, mesh=mesh)
    if mesh is not None and not mesh.is_writer:
        return 0
    print(f"teacher PER={res['teacher_per']:.4f} student PER={res['student_per']:.4f} "
          f"({args.rounds} rounds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
