"""One-command unsupervised pipeline (counterpart of ``uasr.tools.pipeline``):
SSL pretraining -> featurize -> LM -> multi-seed GAN / EODM sweep with
label-free selection -> self-training, each stage resumable.

  python -m uasr_torch.tools.pipeline --workdir exp/pipe \\
      --ssl-config configs/ssl.yaml --unsup-config configs/gan.yaml \\
      --seeds 3 --cmvn --selftrain-rounds 1 [--set-unsup k=v ...] [--device cuda|cpu]

Stages (each records itself in <workdir>/pipeline.json and is skipped on
rerun; --force-from STAGE runs a stage and every stage after it again):

  ssl        train.mode=ssl pretraining              -> workdir/ssl
  featurize  train/dev feature caches                -> workdir/feats/*
  lm         bigram LM of the unpaired text          -> workdir/lm.npz
             (skipped when the recipe sets gan.select_lm_path)
  sweep      N-seed GAN / EODM + label-free select   -> workdir/unsup/seed*
  selftrain  pseudo-labels (Viterbi-HMM with ctc.use_viterbi) -> CTC
             student                                 -> workdir/student

Without --ssl-config the ssl and featurize stages are skipped and the
unsupervised recipe trains on its own data source. The stages run in this
process through the port's own entry points (``cli._train_ssl``,
``tools.featurize.dump_features``, ``cli._train_gan`` / ``_train_eodm``,
``tools.selftrain.run_selftrain``) on ``--device`` (default cuda; raises
without a card). <workdir>/report.json holds the winner, the teacher's
and student's dev PER and the stage records; ``export_winner.yaml`` and
``export_student.yaml`` are the resolved recipes ``tools.export`` freezes
(``--compose-from-pipeline <workdir>`` puts the featurizer in front).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import json
import math
import os
import sys
import time

STAGES = ("ssl", "featurize", "lm", "sweep", "selftrain")


class _Manifest:
    """Stage ledger at <workdir>/pipeline.json: completed stages are
    skipped on rerun (the tools also resume inside a stage, so a stage
    killed mid-run continues where it stopped). Each record carries a
    digest of the arguments the stage ran with; a rerun with other
    arguments for a COMPLETED stage is refused (the skip would keep
    artifacts built under the old settings) unless --force-from clears
    that stage."""

    def __init__(self, workdir: str, force_from: str | None):
        self.path = os.path.join(workdir, "pipeline.json")
        self.stages: dict = {}
        self.digests: dict = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                blob = json.load(f)
            self.stages = blob.get("stages", {})
            self.digests = blob.get("digests", {})
        if force_from:
            for s in STAGES[STAGES.index(force_from):]:
                self.stages.pop(s, None)
                self.digests.pop(s, None)
            self._save()

    def check(self, current: dict) -> None:
        """Refuse to skip a completed stage whose recorded digest differs
        from this invocation's (records without a digest pass)."""
        stale = [s for s in STAGES
                 if s in self.stages and s in self.digests
                 and s in current and self.digests[s] != current[s]]
        if stale:
            raise SystemExit(
                f"stage(s) {stale} were completed with different arguments/configs than this "
                "invocation's — their artifacts would be silently reused under the wrong "
                f"settings. Re-run with --force-from {stale[0]} to rebuild them (and "
                "everything after), or restore the original arguments.")

    def done(self, stage: str) -> dict | None:
        return self.stages.get(stage)

    def record(self, stage: str, info: dict, digest: str | None = None) -> None:
        self.stages[stage] = info
        if digest is not None:
            self.digests[stage] = digest
        self._save()

    def _save(self) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "w") as f:
            json.dump({"stages": self.stages, "digests": self.digests}, f, indent=1)


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()[:16]


def _file_digest(path: str | None) -> str | None:
    if path is None:
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _stage_digests(args) -> dict:
    """Digest of the arguments each stage's artifacts depend on; recipe
    FILE CONTENTS, not paths, so an edited recipe is caught."""
    ssl_in = [_file_digest(args.ssl_config), sorted(args.set_ssl)]
    unsup_in = [_file_digest(args.unsup_config), sorted(args.set_unsup)]
    return {
        "ssl": _digest(ssl_in),
        "featurize": _digest([ssl_in, args.cmvn, args.pca, args.pool_kmeans]),
        "lm": _digest(unsup_in),
        "sweep": _digest([unsup_in, args.seeds]),
        "selftrain": _digest(
            [unsup_in, args.selftrain_rounds, args.conf_threshold, args.student_steps,
             args.gold_list, args.init_student_from_teacher, args.no_full_length,
             args.align_pseudo_labels, args.student_encoder, sorted(args.set_student)]),
    }


def _null_nonfinite(rec: dict, keys) -> dict:
    """Non-finite floats -> None: without a dev split run_selftrain reports
    NaN PERs, and json.dumps would write a literal NaN, which strict JSON
    readers refuse."""
    for k in keys:
        v = rec.get(k)
        if isinstance(v, float) and not math.isfinite(v):
            rec[k] = None
    return rec


def _log(msg: str) -> None:
    print(f"[pipeline] {msg}", file=sys.stderr)


def _stage(manifest: _Manifest, name: str, fn, digest: str | None = None):
    """Run (or skip) one stage; returns its manifest record."""
    rec = manifest.done(name)
    if rec is not None:
        _log(f"stage {name}: done (skip)")
        return rec
    _log(f"stage {name}: running")
    t0 = time.monotonic()
    rec = fn() or {}
    rec["seconds"] = round(time.monotonic() - t0, 1)
    manifest.record(name, rec, digest=digest)
    _log(f"stage {name}: finished in {rec['seconds']}s")
    return rec


def _has_dev(cfg) -> bool:
    return bool(cfg.data.synthetic or cfg.data.dev_list is not None
                or cfg.data.dev_feature_cache is not None)


def run_pipeline(args) -> dict:
    from uasr_torch import resolve_device
    from uasr_torch.cli import (
        _load_source, _load_text, _train_eodm, _train_gan, _train_ssl, apply_overrides,
    )
    from uasr_torch.config import load_config, save_config

    device = resolve_device(args.device)
    workdir = args.workdir
    os.makedirs(workdir, exist_ok=True)
    manifest = _Manifest(workdir, args.force_from)
    digests = _stage_digests(args)
    manifest.check(digests)

    cfg_unsup = load_config(args.unsup_config)
    apply_overrides(cfg_unsup, args.set_unsup)
    if cfg_unsup.train.mode not in ("gan", "gan+eodm", "eodm"):
        raise SystemExit(
            "the pipeline drives the UNSUPERVISED lineage; the unsup recipe's train.mode is "
            f"{cfg_unsup.train.mode!r} (want gan / gan+eodm / eodm)")

    # ---- ssl + featurize
    feats_dir = os.path.join(workdir, "feats")
    if args.ssl_config:
        cfg_ssl = load_config(args.ssl_config)
        apply_overrides(cfg_ssl, args.set_ssl)
        cfg_ssl = cfg_ssl.replace(model_dir=os.path.join(workdir, "ssl"))
        ssl_source, ssl_vocab = _load_source(cfg_ssl, "train")
        if cfg_ssl.vocab_size is None:
            cfg_ssl = cfg_ssl.replace(vocab_size=len(ssl_vocab))

        def do_ssl():
            _train_ssl(cfg_ssl, ssl_source, device)
            # the RESOLVED ssl recipe (model_dir, vocab_size pinned): the
            # export rebuilds the featurizer from it (--compose-from-pipeline)
            resolved = os.path.join(workdir, "ssl_resolved.yaml")
            save_config(cfg_ssl, resolved)
            return {"model_dir": cfg_ssl.model_dir, "config": resolved}

        _stage(manifest, "ssl", do_ssl, digest=digests["ssl"])

        def do_featurize():
            from uasr_torch.tools.featurize import dump_features

            train_dir = os.path.join(feats_dir, "train")
            n = dump_features(cfg_ssl, ssl_source, train_dir, cmvn=args.cmvn, pca_dim=args.pca,
                              pool_clusters=args.pool_kmeans, device=device)
            rec = {"train": train_dir, "train_utts": n, "cmvn": bool(args.cmvn),
                   "pca": args.pca, "pool_kmeans": args.pool_kmeans}
            if _has_dev(cfg_ssl):
                dev_dir = os.path.join(feats_dir, "dev")
                dev_source, _ = _load_source(cfg_ssl, "dev")
                fitted = args.pca or args.pool_kmeans
                rec["dev_utts"] = dump_features(
                    cfg_ssl, dev_source, dev_dir, cmvn=args.cmvn, pca_dim=args.pca,
                    pool_clusters=args.pool_kmeans,
                    transforms_from=train_dir if fitted else None, device=device)
                rec["dev"] = dev_dir
            return rec

        feat_rec = _stage(manifest, "featurize", do_featurize, digest=digests["featurize"])
        # the unsupervised recipe reads the dumped caches (it keeps its own
        # only when no ssl stage runs)
        cfg_unsup.data.feature_cache = feat_rec["train"]
        cfg_unsup.data.dev_feature_cache = feat_rec.get("dev")
        if cfg_unsup.data.vocab_path is None:
            # a cache source needs a token list: the ssl corpus's
            vocab_path = os.path.join(workdir, "vocab.txt")
            if not os.path.exists(vocab_path):
                with open(vocab_path, "w") as f:
                    f.write("\n".join(ssl_vocab.tokens) + "\n")
            cfg_unsup.data.vocab_path = vocab_path
    else:
        _log("stage ssl: no --ssl-config (skip)")
        _log("stage featurize: no --ssl-config (skip)")

    source, vocab = _load_source(cfg_unsup, "train")
    if cfg_unsup.vocab_size is None:
        cfg_unsup = cfg_unsup.replace(vocab_size=len(vocab))
    has_dev = _has_dev(cfg_unsup)

    # ---- lm (label-free selection needs one; built when absent)
    if cfg_unsup.gan.select_lm_path is None and has_dev:

        def do_lm():
            from uasr_torch.ops.lm import build_bigram_lm, build_unigram, save_lm

            lm_path = os.path.join(workdir, "lm.npz")
            seqs = _load_text(cfg_unsup, source, vocab)
            blank = (cfg_unsup.ctc.blank_id,)
            logp = build_bigram_lm(seqs, len(vocab), exclude=blank)
            save_lm(lm_path, logp, unigram=build_unigram(seqs, len(vocab), exclude=blank))
            return {"lm_path": lm_path, "sequences": len(seqs)}

        lm_rec = _stage(manifest, "lm", do_lm, digest=digests["lm"])
        cfg_unsup.gan.select_lm_path = lm_rec["lm_path"]
        if cfg_unsup.ctc.use_viterbi and cfg_unsup.ctc.lm_path is None:
            cfg_unsup.ctc.lm_path = lm_rec["lm_path"]  # HMM labelling reuses it
    elif cfg_unsup.gan.select_lm_path is not None:
        if not os.path.exists(cfg_unsup.gan.select_lm_path):
            raise SystemExit(
                f"gan.select_lm_path={cfg_unsup.gan.select_lm_path} does not exist — build it "
                "with `prepare lm` / import-arpa, or unset it to let the pipeline build one")
        _log("stage lm: recipe provides gan.select_lm_path (skip)")
    else:
        if args.seeds > 1:
            raise SystemExit(
                "multi-seed selection needs a dev split (synthetic, data.dev_list, or "
                "data.dev_feature_cache) for the label-free selector; add one or run --seeds 1")
        _log("stage lm: no dev split, selection disabled (skip)")

    # ---- sweep
    unsup_root = os.path.join(workdir, "unsup")
    select = cfg_unsup.gan.select_lm_path is not None
    eodm_only = cfg_unsup.train.mode == "eodm"

    def do_sweep():
        results = []
        for seed in range(args.seeds):
            seed_dir = os.path.join(unsup_root, f"seed{seed}")
            cfg_s = cfg_unsup.replace(model_dir=seed_dir,
                                      train=dataclasses.replace(cfg_unsup.train, seed=seed))
            _log(f"sweep: seed {seed} -> {seed_dir}")
            # the train loops restore the newest checkpoint, so finished
            # seeds fall through at once
            if eodm_only:
                _train_eodm(cfg_s, source, vocab, device)
            else:
                _train_gan(cfg_s, source, vocab, device,
                           with_eodm="+eodm" in cfg_unsup.train.mode)
            rec = {"seed": seed, "model_dir": seed_dir}
            if select:
                score_path = os.path.join(seed_dir, "best_ckpt", "score.json")
                if not os.path.exists(score_path):
                    raise SystemExit(f"seed {seed} finished without {score_path} — did the run "
                                     "reach train.eval_every?")
                with open(score_path) as f:
                    sc = json.load(f)
                rec.update(score=sc["score"], step=sc["step"])
                _log(f"sweep: seed {seed} unsup_score {sc['score']:.4f}")
            results.append(rec)
        if select:
            results.sort(key=lambda r: r["score"], reverse=True)
        out = {"winner": results[0], "ranking": results,
               "selection": ("label-free (mean LM token log-prob - usage-KL)" if select
                             else "single seed")}
        with open(os.path.join(unsup_root, "sweep.json"), "w") as f:
            json.dump(out, f, indent=1)
        return out

    sweep_rec = _stage(manifest, "sweep", do_sweep, digest=digests["sweep"])
    winner = sweep_rec["winner"]
    _log(f"winner: {winner['model_dir']}")

    # the resolved export recipes: `tools.export -c <recipe>
    # [--compose-from-pipeline <workdir>]` freezes the winner / student
    cfg_w = copy.deepcopy(cfg_unsup).replace(model_dir=winner["model_dir"])
    cfg_w.train.restore_best = select
    save_config(cfg_w, os.path.join(workdir, "export_winner.yaml"))

    # ---- selftrain
    st_rec = None
    if args.selftrain_rounds > 0:

        def do_selftrain():
            from uasr_torch.tools.selftrain import run_selftrain

            # a deep copy: Config.replace is shallow, and --set-student
            # must not change the sweep recipe's sub-configs
            cfg_st = copy.deepcopy(cfg_unsup).replace(model_dir=os.path.join(workdir, "student"))
            if args.student_encoder:
                cfg_st.model.encoder = args.student_encoder
            apply_overrides(cfg_st, args.set_student)
            if cfg_st.ctc.use_viterbi and cfg_st.ctc.lm_path is None and cfg_st.gan.select_lm_path:
                cfg_st.ctc.lm_path = cfg_st.gan.select_lm_path  # HMM labelling reuses it
            res = run_selftrain(
                cfg_st, winner["model_dir"], teacher_mode="eodm" if eodm_only else "gan",
                rounds=args.selftrain_rounds, conf_threshold=args.conf_threshold,
                student_steps=args.student_steps, gold_list=args.gold_list,
                restore_best=select, init_from_teacher=args.init_student_from_teacher,
                full_length=not args.no_full_length,
                align_pseudo_labels=args.align_pseudo_labels, device=device)
            # student checkpoints are plain CTC TrainStates: the export
            # recipe says so (the unsup mode would restore a GANState)
            cfg_exp = copy.deepcopy(cfg_st).replace(model_dir=res["student_dir"])
            cfg_exp.train.mode = "ctc"
            cfg_exp.train.restore_best = False
            save_config(cfg_exp, os.path.join(workdir, "export_student.yaml"))
            return _null_nonfinite(res, ("teacher_per", "student_per"))

        st_rec = _stage(manifest, "selftrain", do_selftrain, digest=digests["selftrain"])
    else:
        _log("stage selftrain: --selftrain-rounds 0 (skip)")

    report = {"workdir": workdir, "winner": winner, "stages": manifest.stages,
              "final_model": winner["model_dir"]}
    if st_rec is not None:
        for k in ("teacher_per", "student_per", "student_dir"):
            report[k] = st_rec[k]
        t, s = st_rec["teacher_per"], st_rec["student_per"]
        # the refinement never ships a WORSE model than its teacher: unless
        # the student at least matches the teacher's dev PER, the
        # deliverable stays the sweep winner
        if t is None or s is None:
            _log("WARNING: self-training student not validated (no dev PER available) — "
                 "final_model stays the sweep winner; the student is kept under "
                 f"{st_rec['student_dir']}")
        elif s > t:
            _log(f"WARNING: self-training did not help (student dev PER {s:.4f} > teacher "
                 f"{t:.4f}) — final_model stays the sweep winner; the student is kept under "
                 f"{st_rec['student_dir']} for inspection")
        else:
            report["final_model"] = st_rec["student_dir"]
    with open(os.path.join(workdir, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None):
    p = argparse.ArgumentParser("uasr_torch.tools.pipeline", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True, help="pipeline root (every stage's outputs)")
    p.add_argument("--ssl-config", default=None,
                   help="train.mode=ssl recipe; omit to train the unsup recipe on its own data")
    p.add_argument("--unsup-config", required=True, help="train.mode gan/gan+eodm/eodm recipe")
    p.add_argument("--seeds", type=int, default=3,
                   help="GAN basins are seed-sensitive; train N and select label-free (needs "
                        "a dev split)")
    p.add_argument("--cmvn", action="store_true",
                   help="standardise the dumped SSL features per utterance")
    p.add_argument("--pca", type=int, default=None, metavar="DIM",
                   help="wav2vec-U PCA prep on the dumped features")
    p.add_argument("--pool-kmeans", type=int, default=None, metavar="K",
                   help="wav2vec-U adjacent-cluster mean-pooling")
    p.add_argument("--selftrain-rounds", type=int, default=1,
                   help="CTC self-training rounds on the winner's pseudo-labels (0 = stop at "
                        "the sweep)")
    p.add_argument("--conf-threshold", type=float, default=0.0)
    p.add_argument("--gold-list", default=None,
                   help="labeled utterances mixed into every student round")
    p.add_argument("--student-encoder", default=None,
                   help="student model.encoder override (cross-architecture self-training; "
                        "usually with --align-pseudo-labels)")
    p.add_argument("--align-pseudo-labels", action="store_true",
                   help="train students with per-frame CE on forced-aligned pseudo-labels "
                        "instead of CTC on bare transcripts")
    p.add_argument("--init-student-from-teacher", action="store_true",
                   help="fine-tune the student from the sweep winner's generator weights "
                        "(student keeps model.encoder=classifier)")
    p.add_argument("--student-steps", type=int, default=None,
                   help="override train.total_steps per student round")
    p.add_argument("--no-full-length", action="store_true",
                   help="keep the unsup recipe's frame/audio caps in the selftrain stage "
                        "instead of lifting them to the corpus maximum")
    p.add_argument("--force-from", choices=STAGES, default=None,
                   help="run this stage and everything after it again")
    p.add_argument("--set-ssl", action="append", default=[], metavar="K=V",
                   help="override on the ssl recipe")
    p.add_argument("--set-unsup", action="append", default=[], metavar="K=V",
                   help="override on the unsup recipe")
    p.add_argument("--set-student", action="append", default=[], metavar="K=V",
                   help="override on the student recipe (e.g. model.encoder=cnn)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; raises without a card) or cpu (plain versions)")
    args = p.parse_args(argv)

    report = run_pipeline(args)
    if report.get("student_per") is not None:
        _log(f"teacher PER={report['teacher_per']:.4f} student PER={report['student_per']:.4f}")
    print(json.dumps({k: report[k] for k in
                      ("winner", "teacher_per", "student_per", "student_dir", "final_model")
                      if k in report}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
