"""Serving export: the decode as a ``torch.export`` program (counterpart of
``uasr.tools.export``).

  python -m uasr_torch.tools.export -c recipe.yaml --out exp/serve \\
      [--batch 8] [--seconds 8.0] [--device cuda|cpu] [--check] \\
      [--quantize int8|int8-compute] [--compose-from-pipeline WORKDIR] \\
      [--streaming [--chunk-frames N] [--lookback-frames N] [--approx-streaming]]

Writes:
  <out>/model.pt2  ``torch.export`` program of
      (audio [B, L] f32, lengths [B] i32) -> (ids [B, T'], out_len [B])
      (greedy, or beam + shallow-fusion LM per the recipe's ctc.*; a GAN or
      EODM checkpoint through the chain it trained on; with precomputed
      features [B, T, D] for a cache-trained recipe; for ``train.mode:
      ssl`` the featurizer, (features [B, T, D] f32, frame_lengths)),
      traced on ``--device``, its weights inside the program;
  <out>/meta.json  shapes, vocabulary size, decode settings.

``--streaming`` writes the online chunk step of ``serve.StreamingRecognizer``
instead: ``step.pt2`` (state, chunk [B, S] f32) -> (state, ids [B, K],
counts [B]), ``finish.pt2`` (state) -> (state, ids, counts), where state is
a flat tuple of tensors whose first value is ``state0.pt``.

A serving process needs only torch and the port's operators:

  import torch, uasr_torch.ops.library  # registers torch.ops.uasr.*
  prog = torch.export.load("model.pt2").module()
  ids, n = prog(audio, lengths)

The programs call the port's kernels as the ``uasr::`` operators (K1 or
K7 in the frontend, K2 / K5 / K6 by encoder, K4 with ``ctc.use_beam``),
which build at their first launch on the card.

Cache-trained checkpoints (the pipeline's students and winners read SSL
features, not audio) export as audio -> text programs with
``--compose-featurizer SSL_YAML`` or ``--compose-from-pipeline WORKDIR``:
the trained SSL featurizer and the featurize stage's transforms
(per-utterance CMVN, PCA, k-means adjacent pooling) run in front of the
model inside the program.

``--quantize int8`` stores each large weight as int8 values and f32
per-channel scales inside the program and dequantizes them there
(``ops/quantize.py``); ``int8-compute`` also runs the ``cnn`` /
``classifier`` Dense and Conv products on int8 (``model.int8_compute``).
``--check`` reloads each file with ``torch.export.load`` and requires
every output to be bit-equal to the live forward.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils import _pytree as pytree

from uasr_torch.ops import library  # noqa: F401  (registers the operators the programs call)
from uasr_torch.ops.quantize import QLeaf, dequantize_leaf, quantize_tree, quantized_bytes

UNSUP_MODES = ("gan", "eodm", "gan+eodm")


def lm_table(cfg):
    """The recipe's beam LM table on the host, or None; refuses a table
    whose shape does not match the vocabulary, as ``infer.py`` does: a
    mismatched table is never baked into a serving program."""
    if not (cfg.ctc.use_beam and cfg.ctc.lm_path):
        return None
    from uasr_torch.ops.lm import load_lm

    table = load_lm(cfg.ctc.lm_path)
    V = cfg.dim_output
    if table.shape not in ((V + 1, V), (V + 1, V + 1, V)):
        raise ValueError(
            f"ctc.lm_path table shape {table.shape} does not match the model vocabulary "
            f"([{V + 1}, {V}] bigram or [{V + 1}, {V + 1}, {V}] trigram expected)")
    return torch.as_tensor(np.asarray(table, np.float32))


class InferProgram(nn.Module):
    """The offline decode of a restored trainer (``build_infer_fn`` of the
    JAX package): (audio [B, L], lengths [B]) -> (ids [B, T'], out_len
    [B]), as ``infer.run_inference`` decodes a batch minus the scoring;
    [B, T, D] features bypass the frontend. For an ``SSLTrainer`` the
    featurizer: (features [B, T, D] f32, frame lengths). ``featurizer``
    (``ComposedFeaturizer``) runs first when given."""

    def __init__(self, cfg, trainer, featurizer: nn.Module | None = None):
        super().__init__()
        self.cfg = cfg
        self.trainer = trainer  # not a module: its model is registered below
        self.model = trainer.model
        self.featurizer = featurizer
        self.ssl = cfg.train.mode == "ssl"
        if featurizer is None:
            # built now: a lazily built state would be made of the fake
            # tensors of the first trace and kept
            trainer.frontend_state  # noqa: B018
        table = None if self.ssl else lm_table(cfg)
        self.register_buffer("lm_logp", None if table is None
                             else table.to(next(self.model.parameters()).device))

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor):
        from uasr_torch.infer import _logits
        from uasr_torch.ops.decode import ctc_beam_search_decode, ctc_greedy_decode

        cfg = self.cfg
        if self.featurizer is not None:
            audio, lengths = self.featurizer(audio, lengths)
        if self.ssl:
            z, c, _preds, flen = self.trainer.encode(None, audio, lengths)
            feats = c if cfg.ssl.feature_layer == "context" else z
            return feats.float(), flen
        fstate = None if audio.ndim == 3 else self.trainer.frontend_state
        logits, out_len = _logits(cfg, self.model, fstate, audio, lengths,
                                  getattr(self.trainer, "logits_fn", None))
        if cfg.ctc.use_beam:
            ids, n, _ = ctc_beam_search_decode(logits, out_len, cfg.ctc.beam_width,
                                               cfg.ctc.blank_id, lm_logp=self.lm_logp,
                                               lm_weight=cfg.ctc.lm_weight,
                                               lm_bonus=cfg.ctc.lm_bonus)
            return ids, n
        return ctc_greedy_decode(logits, out_len, cfg.ctc.blank_id)


def build_infer_fn(cfg, trainer, featurizer=None) -> InferProgram:
    """The serving forward of ``trainer`` (from ``cli.restore_trainer``)
    in eval mode."""
    return InferProgram(cfg, trainer, featurizer).eval()


class ComposedFeaturizer(nn.Module):
    """audio -> features, the transform chain ``tools.featurize`` applies
    when dumping a cache: the SSL encoder (its ``feature_layer``), then
    per-utterance CMVN over the valid frames (biased std, eps on the std),
    PCA, and k-means adjacent pooling (``ops.segment.quantize`` and
    ``segment_pool``, the on-device counterparts of
    ``data.transforms.assign_clusters`` and ``pool_adjacent``)."""

    def __init__(self, cfg_ssl, ssl_trainer, cmvn: bool, pca=None, km=None):
        super().__init__()
        self.layer = cfg_ssl.ssl.feature_layer
        self.trainer = ssl_trainer
        self.model = ssl_trainer.model
        self.cmvn = cmvn
        ssl_trainer.frontend_state  # noqa: B018  (built before any trace, as above)
        dev = next(self.model.parameters()).device
        for name, a in (("pca_mean", None if pca is None else pca.mean),
                        ("pca_comp", None if pca is None else pca.components),
                        ("centroids", km)):
            self.register_buffer(name, None if a is None else
                                 torch.as_tensor(np.asarray(a, np.float32), device=dev))

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor):
        from uasr_torch.ops.segment import quantize, segment_pool

        z, c, _preds, flen = self.trainer.encode(None, audio, lengths)
        f = (c if self.layer == "context" else z).float()
        mask = (torch.arange(f.shape[1], device=f.device)[None, :] < flen[:, None])[..., None]
        if self.cmvn:
            denom = torch.clamp(flen, min=1).to(f.dtype)[:, None, None]
            mean = torch.sum(f * mask, 1, keepdim=True) / denom
            var = torch.sum(((f - mean) ** 2) * mask, 1, keepdim=True) / denom
            f = (f - mean) / (torch.sqrt(var) + 1e-5)
        if self.pca_mean is not None:
            f = (f - self.pca_mean) @ self.pca_comp.T
        if self.centroids is not None:
            f, flen = segment_pool(f, flen, quantize(f, self.centroids))
        return f, flen


def _composed_parts(args):
    """Resolve the --compose-* flags to (cfg_ssl, cmvn, pca, km), or None
    when no featurizer composition was asked for. ``--compose-from-pipeline
    WORKDIR`` reads the pipeline's manifest: the resolved ssl recipe it
    saved, the featurize stage's cmvn / pca / pool-kmeans, and the train
    cache directory that holds the fitted transforms."""
    if args.compose_from_pipeline:
        wd = args.compose_from_pipeline
        man_path = os.path.join(wd, "pipeline.json")
        if not os.path.exists(man_path):
            raise SystemExit(f"no pipeline.json under {wd}")
        with open(man_path) as f:
            stages = json.load(f).get("stages", {})
        if "ssl" not in stages or "featurize" not in stages:
            raise SystemExit("--compose-from-pipeline: this workdir's pipeline ran without "
                             "ssl/featurize stages (nothing to compose)")
        feat = stages["featurize"]
        args.compose_featurizer = stages["ssl"].get("config",
                                                    os.path.join(wd, "ssl_resolved.yaml"))
        args.feat_cmvn = bool(feat.get("cmvn"))
        if feat.get("pca") or feat.get("pool_kmeans"):
            args.feat_transforms = feat["train"]
    if not args.compose_featurizer:
        return None
    from uasr_torch.cli import apply_overrides
    from uasr_torch.config import load_config

    cfg_ssl = load_config(args.compose_featurizer)
    apply_overrides(cfg_ssl, args.set_featurizer)
    if cfg_ssl.train.mode != "ssl":
        raise SystemExit("--compose-featurizer recipe must be train.mode=ssl, got "
                         f"{cfg_ssl.train.mode!r}")
    pca = km = None
    if args.feat_transforms:
        from uasr_torch.data import transforms as T

        pca, km = T.load_transforms(args.feat_transforms)
        if pca is None and km is None:
            raise SystemExit(f"--feat-transforms {args.feat_transforms}: no {T.PCA_FILE} or "
                             f"{T.KMEANS_FILE} found")
    return cfg_ssl, bool(args.feat_cmvn), pca, km


def build_composed_featurizer(cfg_ssl, cmvn, pca, km, device):
    """(``ComposedFeaturizer`` on the newest checkpoint under
    ``cfg_ssl.model_dir``, its step)."""
    from uasr_torch.cli import restore_trainer

    trainer, step = restore_trainer(cfg_ssl.replace(train=dataclasses.replace(
        cfg_ssl.train, average_checkpoints=1, restore_best=False)), device)
    return ComposedFeaturizer(cfg_ssl, trainer, cmvn, pca, km).eval(), step


class Quantized(nn.Module):
    """``inner`` run on its weights as ``quantize_tree`` stores them: int8
    values and f32 scales (buffers of this module), dequantized to f32 at
    every call. ``inner`` is not registered as a submodule, so its own f32
    weights stay out of an exported program."""

    def __init__(self, inner: nn.Module, qtree: dict):
        super().__init__()
        object.__setattr__(self, "inner", inner)
        self.names, self.shapes = [], {}
        for i, (name, v) in enumerate({**qtree, **dict(inner.named_buffers())}.items()):
            self.names.append(name)
            if isinstance(v, QLeaf):
                self.register_buffer(f"q{i}", v.qint8)
                self.register_buffer(f"s{i}", v.qscale)
                self.shapes[name] = v.shape
            else:
                self.register_buffer(f"p{i}", v.detach())

    def forward(self, *args):
        params = {}
        for i, name in enumerate(self.names):
            if name in self.shapes:
                params[name] = dequantize_leaf(QLeaf(getattr(self, f"q{i}"),
                                                     getattr(self, f"s{i}"), self.shapes[name]))
            else:
                params[name] = getattr(self, f"p{i}")
        return functional_call(self.inner, params, args)


def quantize_programs(*programs: nn.Module):
    """([``Quantized`` program for each], metadata) for ``--quantize``: the
    first program's weights quantized once, shared by programs over the
    same weights."""
    qtree, n_q = quantize_tree(programs[0])
    if n_q == 0:
        raise SystemExit("--quantize int8: no kernels large enough to quantize")
    qb, fb = quantized_bytes(qtree)
    print(f"quantized {n_q} kernels: params {fb / 1e6:.1f} MB -> {qb / 1e6:.1f} MB",
          file=sys.stderr)
    return [Quantized(p, qtree).eval() for p in programs], {
        "quantized_kernels": int(n_q), "params_bytes": int(qb), "float_equivalent_bytes": int(fb)}


def export_program(module: nn.Module, args: tuple, path: str):
    """``torch.export`` of ``module`` on ``args`` (no gradient), saved to
    ``path`` without the example inputs (a B = 32 x 16 s batch of audio
    alone is 33 MB); returns the ExportedProgram."""
    with torch.no_grad():
        ep = torch.export.export(module, args)
    ep.example_inputs = None
    torch.export.save(ep, path)
    return ep


def outputs_equal(got, want) -> None:
    """Raise unless every output tensor is bit-equal to the live one."""
    got, want = pytree.tree_leaves(got), pytree.tree_leaves(want)
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs against the live forward's {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"output {i} differs from the live forward")


def uasr_operators(ep) -> list[str]:
    """The ``torch.ops.uasr`` operators a program calls, in graph order."""
    return [str(n.target) for n in ep.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("uasr.")]


def _random_audio(B: int, L: int, device) -> torch.Tensor:
    rng = np.random.RandomState(0)
    return torch.as_tensor((rng.randn(B, L) * 0.1).astype(np.float32), device=device)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("uasr_torch.tools.export", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--device", default="cuda",
                   help="device the program is traced on: cuda (the kernels; raises without "
                        "a card) or cpu (the plain versions)")
    p.add_argument("--check", action="store_true",
                   help="reload and run against the live forward, bit for bit")
    p.add_argument("--streaming", action="store_true",
                   help="export the online chunk step (serve.StreamingRecognizer) instead of "
                        "the offline batch decode")
    p.add_argument("--chunk-frames", type=int, default=None)
    p.add_argument("--lookback-frames", type=int, default=None,
                   help="streaming window left context (frames)")
    p.add_argument("--approx-streaming", action="store_true",
                   help="allow window-bounded APPROXIMATE streaming for unbounded-context "
                        "encoders (conv_bigru / attention); not exact-parity")
    p.add_argument("--compose-featurizer", default=None, metavar="YAML",
                   help="ssl recipe whose trained model becomes the audio->features stage in "
                        "front of this recipe's model (cache-trained checkpoints as audio->text "
                        "programs)")
    p.add_argument("--set-featurizer", action="append", default=[], metavar="K=V",
                   help="override on the featurizer recipe")
    p.add_argument("--feat-cmvn", action="store_true",
                   help="per-utterance standardisation after the featurizer (featurize --cmvn)")
    p.add_argument("--feat-transforms", default=None, metavar="DIR",
                   help="the PCA / pool-kmeans transforms fitted by a featurize dump (the "
                        "cache directory)")
    p.add_argument("--compose-from-pipeline", default=None, metavar="WORKDIR",
                   help="derive every --compose-* / --feat-* setting from a pipeline "
                        "workdir's manifest")
    p.add_argument("--quantize", choices=["int8", "int8-compute"], default=None,
                   help="int8: weight-only per-channel int8, dequantized inside the program "
                        "(ops/quantize.py); int8-compute: also the Dense / Conv products on "
                        "int8 (cnn / classifier families)")
    p.add_argument("--set", action="append", default=[])
    args = p.parse_args(argv)
    return args


@dataclasses.dataclass
class Built:
    """What ``main`` exports: the programs by file name with their example
    arguments, and what ``meta.json`` says of them so far."""

    cfg: object
    device: torch.device
    step: int
    programs: dict  # name -> (module, example args)
    meta: dict
    state0: tuple | None = None  # the streaming programs' initial state


def build_programs(args) -> Built:
    """Restore the checkpoint the arguments name and build the live
    programs ``main`` exports (also the live side of a check)."""
    from uasr_torch import resolve_device
    from uasr_torch.cli import apply_overrides, restore_trainer
    from uasr_torch.config import load_config

    cfg = load_config(args.config)
    apply_overrides(cfg, args.set)
    device = resolve_device(args.device)
    if cfg.vocab_size is None:
        if not cfg.data.vocab_path:
            raise SystemExit("recipe must pin vocab_size (or set data.vocab_path) for export")
        from uasr_torch.vocab import load_vocab

        cfg = cfg.replace(vocab_size=len(load_vocab(cfg.data.vocab_path)))
    if cfg.train.mode in UNSUP_MODES:
        cfg.model.encoder = "classifier"  # serve the generator
    if args.quantize == "int8-compute":
        if cfg.model.encoder not in ("cnn", "classifier"):
            raise SystemExit(
                "--quantize int8-compute supports the cnn/classifier serving families, got "
                f"{cfg.model.encoder!r} (use --quantize int8 for weight-only PTQ)")
        cfg.model.int8_compute = True
    comp = _composed_parts(args)
    if comp is not None and args.streaming:
        raise SystemExit("--streaming and --compose-featurizer are mutually exclusive (the "
                         "online recognizer has no composed-featurizer state yet)")
    if args.streaming:
        _refuse_streaming(cfg)
    trainer, step = restore_trainer(cfg, device)
    if args.streaming:
        return _build_streaming(cfg, args, trainer, step, device)

    feat_meta = featurizer = None
    if comp is not None:
        cfg_ssl, f_cmvn, f_pca, f_km = comp
        featurizer, fstep = build_composed_featurizer(cfg_ssl, f_cmvn, f_pca, f_km, device)
        feat_meta = {"featurizer_config": args.compose_featurizer, "featurizer_step": fstep,
                     "feature_layer": cfg_ssl.ssl.feature_layer, "cmvn": f_cmvn,
                     "pca_dim": None if f_pca is None else int(f_pca.components.shape[0]),
                     "pool_clusters": None if f_km is None else int(len(f_km))}
    program = build_infer_fn(cfg, trainer, featurizer)
    quant_meta = None
    if args.quantize:
        (program,), quant_meta = quantize_programs(program)
        quant_meta["scheme"] = ("int8_weight_per_channel_symmetric+int8_compute"
                                if args.quantize == "int8-compute"
                                else "int8_weight_per_channel_symmetric")
    B = args.batch
    L = int(args.seconds * cfg.frontend.sample_rate)
    example = (torch.zeros(B, L, device=device),
               torch.full((B,), L, dtype=torch.int32, device=device))
    meta = {
        "audio_shape": [B, L],
        "sample_rate": cfg.frontend.sample_rate,
        "vocab_size": cfg.dim_output,
        "decode": ("features" if cfg.train.mode == "ssl"
                   else "beam" if cfg.ctc.use_beam else "greedy"),
        "beam_width": cfg.ctc.beam_width if cfg.ctc.use_beam else None,
        "lm_path": cfg.ctc.lm_path if cfg.ctc.use_beam else None,
        "device": str(device),
        "checkpoint_step": int(step),
        "composed_featurizer": feat_meta,
        "quantization": quant_meta,
        "calling_convention": "ids, out_len = torch.export.load('model.pt2').module()"
                              "(audio [B, L] f32, lengths [B] i32)",
    }
    return Built(cfg, device, step, {"model": (program, example)}, meta)


def main(argv=None):
    args = parse_args(argv)
    built = build_programs(args)
    os.makedirs(args.out, exist_ok=True)
    paths, ops = {}, {}
    for name, (program, example) in built.programs.items():
        paths[name] = os.path.join(args.out, f"{name}.pt2")
        ops[name] = uasr_operators(export_program(program, example, paths[name]))
    meta = dict(built.meta, operators=ops, program_bytes={n: os.path.getsize(p)
                                                          for n, p in paths.items()})
    if built.state0 is not None:
        torch.save(built.state0, os.path.join(args.out, "state0.pt"))
    else:
        program, example = built.programs["model"]
        with torch.no_grad():
            meta["output_shapes"] = [list(t.shape) for t in program(*example)]
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print(f"exported step-{built.step} programs {meta['program_bytes']} (bytes, device "
          f"{built.device}) -> {args.out}", file=sys.stderr)
    if args.check:
        check_programs(args.out, built)
        print("check ok: the reloaded programs match the live forward", file=sys.stderr)
    return 0


def check_programs(out_dir: str, built: Built) -> None:
    """Reload each program ``main`` wrote under ``out_dir`` and hold every
    output bit-equal to the live one: the offline program on seeded random
    audio, the streaming programs over three chunks and the finish."""
    if built.state0 is not None:
        step_p, finish_p = built.programs["step"][0], built.programs["finish"][0]
        check_streaming(os.path.join(out_dir, "step.pt2"), os.path.join(out_dir, "finish.pt2"),
                        step_p, finish_p, built.state0, built.meta["chunk_samples"],
                        built.device)
        return
    program, (audio, lens) = built.programs["model"]
    audio = _random_audio(*audio.shape, built.device)
    with torch.no_grad():
        outputs_equal(torch.export.load(os.path.join(out_dir, "model.pt2")).module()(audio, lens),
                      program(audio, lens))


def _refuse_streaming(cfg) -> None:
    if cfg.train.mode == "ssl":
        raise SystemExit("--streaming exports a decoding checkpoint, not an ssl featurizer")
    if cfg.train.mode in UNSUP_MODES and cfg.gan.segmenter != "none":
        raise SystemExit(
            "--streaming cannot serve gan.segmenter=kmeans recipes (segment pooling reads the "
            "whole utterance) — export the offline artifact instead")


class StreamProgram(nn.Module):
    """``StreamingRecognizer``'s chunk step (``finish=False``) or its finish
    over a flat tuple of state tensors: (state, chunk) -> (state, ids,
    counts), or (state,) -> (state, ids, counts)."""

    def __init__(self, rec, treedef, finish: bool):
        super().__init__()
        self.rec, self.treedef, self.finish = rec, treedef, finish
        self.model = rec.model

    def forward(self, state: tuple, chunk: torch.Tensor | None = None):
        st = pytree.tree_unflatten(list(state), self.treedef)
        if self.finish:
            st2, ids, counts = self.rec._finish_impl(st)
        else:
            st2, ids, counts = self.rec._step_impl(st, chunk)
        return tuple(pytree.tree_leaves(st2)), ids, counts


def stream_programs(rec, batch: int, quantize: bool = False):
    """(step program, finish program, flat initial state, quantization
    metadata or None) of a recognizer."""
    flat0, treedef = pytree.tree_flatten(rec.init(batch))
    progs = [StreamProgram(rec, treedef, False).eval(), StreamProgram(rec, treedef, True).eval()]
    meta = None
    if quantize:
        progs, meta = quantize_programs(*progs)
        meta["scheme"] = "int8_weight_per_channel_symmetric"
    return progs[0], progs[1], tuple(flat0), meta


def _build_streaming(cfg, args, trainer, step, device) -> Built:
    """The online chunk step's programs: ``step`` and ``finish`` over the
    flat state whose first value ``state0.pt`` holds."""
    from uasr_torch.serve import StreamingRecognizer

    rec = StreamingRecognizer(cfg, trainer.model, chunk_frames=args.chunk_frames,
                              lookback_frames=args.lookback_frames,
                              approx_context=args.approx_streaming, device=device)
    B = args.batch
    cs = rec.chunk_samples
    step_p, finish_p, flat0, quant_meta = stream_programs(rec, B, bool(args.quantize))
    meta = {
        "mode": "streaming",
        "decode": "beam" if rec.use_beam else "greedy",
        "collapse": rec.collapse,
        "approx_context": rec.approx,
        "beam_width": rec.beam_width if rec.use_beam else None,
        "streams": B,
        "chunk_samples": cs,
        "chunk_frames": rec.chunk,
        "lookback_frames": rec.lookback,
        "emit_width": rec.chunk // rec.subsample,
        "sample_rate": cfg.frontend.sample_rate,
        "vocab_size": cfg.dim_output,
        "state_leaves": len(flat0),
        "quantization": quant_meta,
        "device": str(device),
        "checkpoint_step": int(step),
        "calling_convention": ("state = torch.load('state0.pt'); "
                               "state, ids, counts = step(state, chunk); "
                               "state, ids, counts = finish(state)"),
    }
    chunk0 = torch.zeros(B, cs, device=device)
    return Built(cfg, device, step, {"step": (step_p, (flat0, chunk0)),
                                     "finish": (finish_p, (flat0,))}, meta, state0=flat0)


def check_streaming(step_path, finish_path, step_p, finish_p, flat0, cs: int, device,
                    chunks: int = 3) -> None:
    """Three chunks of random audio and the finish through the reloaded
    programs and the live ones, each output bit-equal."""
    B = flat0[0].shape[0]
    audio = _random_audio(B, cs * chunks, device)
    re_step = torch.export.load(step_path).module()
    re_finish = torch.export.load(finish_path).module()
    st_a = st_b = flat0
    with torch.no_grad():
        for k in range(chunks):
            chunk = audio[:, k * cs:(k + 1) * cs]
            got, want = re_step(st_a, chunk), step_p(st_b, chunk)
            outputs_equal(got, want)
            st_a, st_b = got[0], want[0]
        outputs_equal(re_finish(st_a), finish_p(st_b))


if __name__ == "__main__":
    raise SystemExit(main())
