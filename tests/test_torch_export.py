"""Serving export (uasr_torch.tools.export) on the CPU: each program is
exported with ``torch.export``, reloaded with ``torch.export.load`` and
held bit-equal to the live port forward on the same inputs, and its graph
holds the expected ``uasr::`` operators (ops/library.py). The cases: greedy
and beam + bigram LM decode of a cnn (the live ids equal to the JAX
package's ``build_infer_fn`` on the same converted weights), a conv_bigru
(K2) and a conformer (K6), a GAN classifier with k-means segmentation,
the SSL featurizer (K5 in its context), a composed featurizer (SSL ->
CMVN -> PCA -> pooling) in front of a cache-trained classifier,
``--quantize int8`` and ``int8-compute``, and the streaming step and
finish; the CLI with a checkpoint and ``--check``; each of the JAX tool's
refusals; and ``torch.library.opcheck`` of every operator on CPU
tensors."""

import os

import numpy as np
import pytest
import torch

import jax

from uasr.config import load_config as jax_load_config
from uasr.tools.export import build_infer_fn as jax_build_infer_fn
from uasr_torch.checkpoint import CheckpointManager
from uasr_torch.config import FrontendConfig, load_config
from uasr_torch.convert import flax_to_state_dict
from uasr_torch.data.transforms import PCATransform
from uasr_torch.frontend.features import make_frontend_state
from uasr_torch.ops import cuda_beam, library
from uasr_torch.ops.lm import build_bigram_lm, save_lm
from uasr_torch.pretrain import SSLTrainer
from uasr_torch.serve import StreamingRecognizer
from uasr_torch.tools import export
from uasr_torch.train import CTCTrainer, GeneratorInfer

B, L = 2, 8000  # two utterances of 0.5 s
RECIPE = """
name: export_test
vocab_size: 10
frontend: {{num_mel_bins: 24, cmvn: {cmvn}, streaming_chunk_frames: 32}}
model: {model}
ctc: {{beam_width: 8, use_beam: {beam}, lm_path: {lm}, lm_weight: 0.5, lm_bonus: 0.2}}
data: {{max_label_len: 16}}
train: {{mode: {mode}}}
gan: {{segmenter: {seg}, max_segments: 12, merge_repeats: true}}
ssl: {{conv_channels: [8, 8, 16], conv_kernels: [64, 10, 8], conv_strides: [16, 10, 3],
       context_hidden: 16, predict_steps: 2, num_negatives: 0, context_pallas: true,
       feature_layer: context}}
"""
CNN = "{encoder: cnn, hidden_size: 32, num_conv_layers: 2, conv_kernel: 5}"
CLS = "{encoder: classifier, classifier_hidden: 16, classifier_layers: 2}"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    rng = np.random.RandomState(0)
    lm = str(root / "lm.npz")
    save_lm(lm, build_bigram_lm([rng.randint(1, 10, 6) for _ in range(40)], 10, exclude=(0,)))
    audio = np.zeros((B, L), np.float32)
    audio[0] = rng.randn(L) * 0.1
    audio[1, :5000] = rng.randn(5000) * 0.1
    return dict(root=root, lm=lm, audio=audio, lens=np.array([L, 5000], np.int32))


def _recipe(env, name, model=CNN, mode="ctc", beam=False, lm=False, seg="none",
            cmvn="utterance"):
    path = env["root"] / f"{name}.yaml"
    path.write_text(RECIPE.format(model=model, mode=mode, beam=str(beam).lower(),
                                  lm=env["lm"] if lm else "null", seg=seg, cmvn=cmvn))
    return str(path)


def _jax_weights(cfg_path, env):
    """The JAX package's build_infer_fn on seeded weights: (fn, params as
    numpy)."""
    jcfg = jax_load_config(cfg_path)
    fn, init = jax_build_infer_fn(jcfg)
    params = init(jax.random.PRNGKey(0), env["audio"], env["lens"])
    return jax.jit(fn), jax.tree.map(np.asarray, params)


def _ctc_trainer(cfg_path, env, jax_ref=False):
    cfg = load_config(cfg_path)
    trainer = CTCTrainer(cfg, device="cpu")
    if jax_ref:
        fn, params = _jax_weights(cfg_path, env)
        trainer.model.load_state_dict(flax_to_state_dict(params, cfg))
        return cfg, trainer, (fn, params)
    return cfg, trainer, None


def _roundtrip(tmp_path, module, args, ops):
    """Export, reload, compare bit for bit, check the graph's operators;
    returns the live outputs."""
    path = str(tmp_path / "prog.pt2")
    ep = export.export_program(module, args, path)
    assert set(export.uasr_operators(ep)) == {f"uasr.{o}.default" for o in ops}
    with torch.no_grad():
        want = module(*args)
        export.outputs_equal(torch.export.load(path).module()(*args), want)
    return want


def _t(env):
    return torch.tensor(env["audio"]), torch.tensor(env["lens"])


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam_lm"])
def test_cnn_decode_program_matches_jax_and_reloads(env, tmp_path, beam):
    cfg, trainer, (jfn, params) = _ctc_trainer(
        _recipe(env, f"cnn_{beam}", beam=beam, lm=beam), env, jax_ref=True)
    prog = export.build_infer_fn(cfg, trainer)
    ops = ("log_mel_fused", "ctc_beam") if beam else ("log_mel_fused",)
    ids, n = _roundtrip(tmp_path, prog, _t(env), ops)
    jids, jn = jfn(params, env["audio"], env["lens"])[:2]
    assert n.tolist() == np.asarray(jn).tolist()
    for b, m in enumerate(n.tolist()):
        assert ids[b, :m].tolist() == np.asarray(jids)[b, :m].tolist()


@pytest.mark.parametrize("model,op", [
    ("{encoder: conv_bigru, hidden_size: 16, num_gru_layers: 1, conv_channels: 4, "
     "gru_pallas: true}", "bigru_scan"),
    ("{encoder: conformer, hidden_size: 32, num_heads: 2, transformer_layers: 1, ffn_dim: 32, "
     "conv_channels: 4, attn_pallas: true}", "mhsa_fwd"),
], ids=["conv_bigru", "conformer"])
def test_encoder_kernels_in_program(env, tmp_path, model, op):
    cfg, trainer, _ = _ctc_trainer(_recipe(env, op, model=model), env)
    _roundtrip(tmp_path, export.build_infer_fn(cfg, trainer), _t(env), ("log_mel_fused", op))


def test_gan_kmeans_program(env, tmp_path):
    cfg = load_config(_recipe(env, "gan", model=CLS, mode="gan", seg="kmeans"))
    centroids = np.random.RandomState(1).randn(6, 24).astype(np.float32)
    trainer = GeneratorInfer(cfg, device="cpu", centroids=centroids)
    ids, n = _roundtrip(tmp_path, export.build_infer_fn(cfg, trainer), _t(env),
                        ("log_mel_fused",))
    assert ids.shape == (B, 12) and (n <= 12).all()


def _ssl(env):
    cfg = load_config(_recipe(env, "ssl", mode="ssl"))
    return cfg, SSLTrainer(cfg, device="cpu")


def test_ssl_featurizer_program(env, tmp_path):
    cfg, trainer = _ssl(env)
    feats, flen = _roundtrip(tmp_path, export.build_infer_fn(cfg, trainer), _t(env),
                             ("gru_scan",))
    assert feats.dtype == torch.float32 and feats.shape[-1] == 16
    assert flen.tolist() == [17, 11]


def test_composed_featurizer_program(env, tmp_path):
    cfg_ssl, ssl = _ssl(env)
    rng = np.random.RandomState(2)
    pca = PCATransform(mean=rng.randn(16).astype(np.float32),
                       components=rng.randn(8, 16).astype(np.float32) * 0.3,
                       explained=np.ones(8, np.float32))
    feat = export.ComposedFeaturizer(cfg_ssl, ssl, True, pca, rng.randn(4, 8).astype(np.float32))
    cfg = load_config(_recipe(env, "composed", model=CLS, mode="gan"))
    cfg = cfg.replace(frontend=FrontendConfig(num_mel_bins=8))  # the model reads 8 PCA dims
    trainer = GeneratorInfer(cfg, device="cpu")
    ids, n = _roundtrip(tmp_path, export.build_infer_fn(cfg, trainer, feat.eval()), _t(env),
                        ("gru_scan",))
    assert ids.shape[0] == B


@pytest.mark.parametrize("scheme", ["int8", "int8-compute"])
def test_quantized_program(env, tmp_path, scheme):
    cfg, trainer, _ = _ctc_trainer(_recipe(env, "q8", beam=True), env)
    if scheme == "int8-compute":
        cfg.model.int8_compute = True
        q8 = CTCTrainer(cfg, device="cpu")
        q8.model.load_state_dict(trainer.model.state_dict())
        trainer = q8
    (prog,), meta = export.quantize_programs(export.build_infer_fn(cfg, trainer))
    assert meta["params_bytes"] < meta["float_equivalent_bytes"] / 2
    # the program holds the int8 leaves, not the model's f32 weights
    assert not any(n.startswith("inner") for n, _ in prog.named_buffers())
    assert any(b.dtype == torch.int8 for b in prog.buffers())
    _roundtrip(tmp_path, prog, _t(env), ("log_mel_fused", "ctc_beam"))


def test_streaming_programs(env, tmp_path):
    cfg, trainer, _ = _ctc_trainer(_recipe(env, "stream", beam=True, cmvn="streaming"), env)
    rec = StreamingRecognizer(cfg, trainer.model, device="cpu")
    step, finish, flat0, _ = export.stream_programs(rec, B)
    cs = rec.chunk_samples
    paths = [str(tmp_path / f"{n}.pt2") for n in ("step", "finish")]
    ep_s = export.export_program(step, (flat0, torch.zeros(B, cs)), paths[0])
    ep_f = export.export_program(finish, (flat0,), paths[1])
    assert set(export.uasr_operators(ep_s)) == {"uasr.log_mel_unfused.default",
                                               "uasr.ctc_beam.default"}
    assert "uasr.ctc_beam.default" in export.uasr_operators(ep_f)
    export.check_streaming(paths[0], paths[1], step, finish, flat0, cs, "cpu", chunks=4)


def test_cli_exports_a_checkpoint_and_checks(env, tmp_path):
    cfg_path = _recipe(env, "cli")
    cfg = load_config(cfg_path)
    trainer = CTCTrainer(cfg.replace(model_dir=str(tmp_path / "m")), device="cpu")
    CheckpointManager(str(tmp_path / "m" / "ckpt")).save(7, trainer.init_state())
    out = tmp_path / "out"
    assert export.main(["-c", cfg_path, "--out", str(out), "--device", "cpu", "--batch", "2",
                        "--seconds", "0.5", "--quantize", "int8", "--check",
                        "--set", f"model_dir={tmp_path / 'm'}"]) == 0
    import json

    meta = json.loads((out / "meta.json").read_text())
    assert meta["checkpoint_step"] == 7 and meta["audio_shape"] == [2, 8000]
    assert meta["quantization"]["scheme"] == "int8_weight_per_channel_symmetric"
    assert meta["operators"] == {"model": ["uasr.log_mel_fused.default"]}
    assert os.path.getsize(out / "model.pt2") == meta["program_bytes"]["model"]


def test_refusals(env, tmp_path):
    out = str(tmp_path / "o")
    bigru = "{encoder: conv_bigru, hidden_size: 16, num_gru_layers: 1, conv_channels: 4}"
    with pytest.raises(SystemExit, match="int8-compute supports the cnn/classifier"):
        export.main(["-c", _recipe(env, "r1", model=bigru), "--out", out, "--device", "cpu",
                     "--quantize", "int8-compute"])
    ssl_yaml = _recipe(env, "r_ssl", mode="ssl")
    with pytest.raises(SystemExit, match="mutually exclusive"):
        export.main(["-c", _recipe(env, "r2", model=CLS, mode="gan"), "--out", out,
                     "--device", "cpu", "--streaming", "--compose-featurizer", ssl_yaml])
    with pytest.raises(SystemExit, match="not an ssl featurizer"):
        export.main(["-c", ssl_yaml, "--out", out, "--device", "cpu", "--streaming"])
    with pytest.raises(SystemExit, match="cannot serve gan.segmenter=kmeans"):
        export.main(["-c", _recipe(env, "r3", model=CLS, mode="gan", seg="kmeans"), "--out",
                     out, "--device", "cpu", "--streaming"])
    bad = str(tmp_path / "bad_lm.npz")
    save_lm(bad, np.zeros((5, 4), np.float32))
    cfg = load_config(_recipe(env, "r4", beam=True, lm=True))
    cfg.ctc.lm_path = bad
    with pytest.raises(ValueError, match="does not match the model vocabulary"):
        export.lm_table(cfg)


def _op_cases():
    torch.manual_seed(0)
    st = make_frontend_state(FrontendConfig(num_mel_bins=8, n_fft=64, sample_rate=1600),
                             device="cpu")
    a = torch.randn(2, 100)
    T, Bq, H = 3, 2, 8
    wh, bh = torch.randn(2, H, 3 * H) * 0.1, torch.randn(2, 3 * H)
    tm = torch.ones(T, 2, Bq, dtype=torch.bool)
    q, k, v = (torch.randn(2, 8, 32) for _ in range(3))
    km = torch.ones(2, 1, 8, dtype=torch.int32)
    lp = torch.log_softmax(torch.randn(2, 4, 5), -1)
    s = cuda_beam.beam_init(2, 3)
    return {
        "log_mel_fused": (library.log_mel_fused, (
            a, st.pre_cos, st.pre_sin, st.pre_bvec, st.mel_fb, st.pre_pack, st.mel_runs,
            st.mel_w, 40, 16, 64, "highest", True)),
        "log_mel_unfused": (library.log_mel_unfused, (
            a, st.window, st.cos_basis, st.sin_basis, st.mel_fb, st.dft_pack, st.mel_runs,
            st.mel_w, 40, 16, 64, "highest", False)),
        "bigru_scan": (library.bigru_scan, (torch.randn(T, Bq, 3 * H), torch.randn(T, Bq, 3 * H),
                                            wh, bh, tm)),
        "gru_scan": (library.gru_scan, (torch.randn(T, 1, Bq, 3 * H), wh[:1], bh[:1], tm[:, :1],
                                        False)),
        "gru_scan_coeffs": (library.gru_scan, (torch.randn(T, 1, Bq, 3 * H), wh[:1], bh[:1],
                                               tm[:, :1], True)),
        "mhsa_fwd": (library.mhsa_fwd, (q, k, v, torch.randn(2, 8, 8), km, 2)),
        "mhsa_fwd_nobias": (library.mhsa_fwd, (q, k, v, None, km, 2)),
        "ctc_beam": (library.ctc_beam, (lp, torch.tensor([4, 2]), None, *s, 3, 0, 0, 1.0, 0.0)),
        "ctc_beam_lm": (library.ctc_beam, (lp, torch.tensor([4, 0]), torch.randn(6, 5), *s, 3, 0,
                                           2, 0.5, 0.1)),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_operator_opcheck_cpu(case):
    op, args = _op_cases()[case]
    assert op._name in library.OPERATORS
    torch.library.opcheck(op, args)
