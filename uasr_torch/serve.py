"""Online streaming recognizer: chunked audio in, incremental tokens out
(counterpart of ``uasr.serve``).

The same checkpoint answers online with bounded latency and exact parity:

    streamed tokens == offline greedy decode of the full utterance

for encoders with a finite receptive field (``cnn``, window replay) and
for the causal recurrent encoders (``uni_gru``, ``lc_bigru``, carried
state). The recurrent ones keep no window: the encoder's own streaming
carry (conv tail, GRU states, ``lc_bigru``'s chunk buffers) rides across
chunks. ``uni_gru`` emits each chunk's tokens at once; ``lc_bigru`` emits
the chunk ``num_gru_layers`` chunks back (each layer's backward window
needs the next chunk) and ``finish()`` flushes that lag with zero-input
steps. Each ``lc_bigru`` step runs kernel K5 once per layer, for the
window-bounded backward GRU; the forward GRUs carry their state through
the plain step loop, as the JAX package's do.

For the window-replay encoders a rolling feature window of
``lookback + 2 * chunk`` frames is re-encoded at every chunk:

  - audio arrives in chunks of ``chunk_frames * frame_shift`` samples; the
    causal streaming frontend (``stream_chunk``, kernel K7 on the card)
    turns each into exactly ``chunk_frames`` feature frames, with the
    running CMVN state carried across chunks, so the features equal the
    offline ``streaming_features`` path;
  - the encoder runs on the whole window each step and the logits of the
    PREVIOUS chunk's region, which now has a full chunk of real right
    context, are decoded (one chunk of emission latency);
  - greedy collapse carries the last raw argmax id across chunk
    boundaries, so repeats spanning a boundary collapse as offline;
  - ``finish()`` decodes the final region against the encoder's own
    length masking.

Beam mode (``ctc.use_beam``): the exact prefix beam state is carried
across chunks (kernel K4 fed the region's log-probs from the carried
state, ``beam_advance``) with each beam's prefix materialised, so
``finish()`` returns the complete best transcript, equal to the offline
beam decode. ``step()`` still emits greedy partials. With ``ctc.lm_path``
the beam fuses a bigram or trigram table (loaded onto the device once);
the carried state holds each beam's last two symbols, so a trigram's
history crosses chunk boundaries. Greedy streaming ignores the LM, as the
JAX package's does.

``approx_context=True`` streams an unbounded-context encoder
(``conv_bigru``, the BiGRU through kernel K2) on the rolling window only:
not exact, equal to the offline decode while the window covers the whole
utterance.

A GAN or EODM checkpoint trained with ``gan.merge_repeats`` (the
``classifier`` generator, window replay) streams with the merged-stream
collapse: greedy decode of the merged stream equals a repeat collapse
over the raw frame argmaxes that drops blanks without resetting the
carried id (a run's pooled posterior keeps the run's argmax), so blank-
separated repeats emit once. It is greedy only, and refuses
``gan.segmenter=kmeans`` (segment pooling needs the whole utterance).

The dynamic-batching primitives (``masked_step``, ``masked_step_and_finish``,
``finish_and_reset``, ``reset_slots``, ``set_valid_samples``) step,
finish, reset and stamp subsets of slots for the serving daemon
(``uasr_torch.tools.serve_daemon``), with the JAX package's packed layouts:
inputs ride one upload (mask, stamp mask and stamped samples bit-cast into
three trailing float32 columns of the audio matrix), outputs come back as
one [B, K+1] int32 tensor whose last column is the count. The per-slot
select knows each carry's batch axis: ``uni_gru``'s stacked GRU state is
[L, B, H]; every other leaf has the batch leading. (The JAX package's
``_select_slots`` treats ``lc_bigru``'s carry as ``uni_gru``'s and raises
on it; ROADMAP.md Queue 3.)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uasr_torch import profiling, resolve_device
from uasr_torch.config import Config, ModelConfig
from uasr_torch.frontend.features import frontend_state_from_config
from uasr_torch.frontend.streaming import StreamState, init_stream_state, stream_chunk
from uasr_torch.models.models import (
    encoder_time_subsample, lc_initial_carry, uni_gru_initial_carry,
)
from uasr_torch.ops.cuda_beam import (
    BeamState, _logaddexp, ancestor_maps, beam_init, compact_left, ctc_beam_steps,
)
from uasr_torch.ops.lm import load_decode_table

_OPEN = 1 << 30  # frame cap of an open-ended stream


def streaming_receptive_field(cfg: ModelConfig) -> tuple[int, int]:
    """(half width in feature frames, time subsampling) of a finite-RF
    encoder. Raises ValueError for encoders whose context is unbounded."""
    if cfg.encoder == "classifier":
        return cfg.classifier_context, 1
    if cfg.encoder == "cnn":
        half = cfg.conv_kernel // 2  # first (strided) conv, input rate
        s = cfg.conv_time_stride
        for _ in range(max(cfg.num_conv_layers, 1) - 1):
            half += (cfg.conv_kernel // 2) * s
        for i in range(2):  # dilated residual stack
            half += (cfg.conv_kernel // 2) * (2 ** (i + 1)) * s
        return half, s
    raise ValueError(
        f"encoder {cfg.encoder!r} has unbounded context and cannot stream exactly; use "
        "'cnn' or 'classifier' (window replay) or 'uni_gru' / 'lc_bigru' (carried recurrent "
        "state), or opt into approximate window-bounded streaming with approx_context=True "
        "(tokens can differ from the offline decode near the window edge)"
    )


class RecognizerState(NamedTuple):
    frontend: StreamState
    feat_buf: torch.Tensor  # [B, W, D] rolling feature window (left-aligned)
    n_frames: torch.Tensor  # [B] feature frames received per stream
    prev_id: torch.Tensor  # [B] last raw argmax id of the decoded prefix
    valid_frames: torch.Tensor  # [B] per-stream feature-frame cap (huge = open)


class BeamRecognizerState(NamedTuple):
    """Greedy state plus the carried beam and each beam's prefix."""

    frontend: StreamState
    feat_buf: torch.Tensor
    n_frames: torch.Tensor
    prev_id: torch.Tensor  # greedy-partials carry
    valid_frames: torch.Tensor
    beam: BeamState
    prefix: torch.Tensor  # [B, W, Lmax] int32, -1 padded
    prefix_len: torch.Tensor  # [B, W]


class RecurrentState(NamedTuple):
    """State of the causal recurrent path: instead of a feature window, the
    encoder's own streaming carry rides across chunks."""

    frontend: StreamState
    carry: tuple  # uni_gru_initial_carry or lc_initial_carry
    n_frames: torch.Tensor  # [B] feature frames received per stream
    prev_id: torch.Tensor  # [B] last raw argmax id of the decoded prefix
    valid_frames: torch.Tensor  # [B] per-stream feature-frame cap


class BeamRecurrentState(NamedTuple):
    frontend: StreamState
    carry: tuple
    n_frames: torch.Tensor
    prev_id: torch.Tensor
    valid_frames: torch.Tensor
    beam: BeamState
    prefix: torch.Tensor  # [B, W, Lmax] int32, -1 padded
    prefix_len: torch.Tensor  # [B, W]


def beam_advance(beam: BeamState, prefix: torch.Tensor, prefix_len: torch.Tensor,
                 logp: torch.Tensor, lengths: torch.Tensor, blank_id: int = 0,
                 lm_table: torch.Tensor | None = None, lm_order: int = 0,
                 lm_weight: float = 1.0, lm_bonus: float = 0.0):
    """Advance a carried beam state AND the materialised per-beam prefixes
    over one chunk of log-probs [B, K, V], with the LM table [H, V]
    (``ctc_beam_steps``' layout) fused when ``lm_order`` is 2 or 3.

    A chunk-local traceback from ALL W beams recovers each surviving beam's
    ancestor at the chunk start and its tokens emitted within the chunk,
    which are appended to the ancestor's prefix (tokens beyond Lmax are
    dropped). Returns (beam, prefix, prefix_len)."""
    B, K, V = logp.shape
    W, L = prefix.shape[1], prefix.shape[2]
    parents, chars, new_beam = ctc_beam_steps(logp.contiguous(), lengths, W, blank_id,
                                              lm_table, lm_order, lm_weight, lm_bonus,
                                              state=beam)
    maps = ancestor_maps(parents)  # [K, B, W]
    cs = chars.gather(2, maps).permute(1, 2, 0)  # [B, W, K] chars along each path
    anc = parents[0].long().gather(1, maps[0])  # [B, W] beam of the chunk's start state
    base = prefix.gather(1, anc[..., None].expand(B, W, L))
    base_len = prefix_len.gather(1, anc)
    keep = cs >= 0
    pos = base_len[..., None] + torch.cumsum(keep, -1) - 1
    pos = torch.where(keep & (pos < L), pos, L)  # overflow and non-emits -> dump column
    out = torch.cat([base, base.new_full((B, W, 1), -1)], -1)
    new_prefix = out.scatter(2, pos, cs.to(out.dtype))[..., :L]
    new_len = torch.clamp(base_len + keep.sum(-1), max=L)
    return new_beam, new_prefix, new_len


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _select(mask: torch.Tensor, new, old):
    """Per-slot select over a (nested) state: slot b takes ``new`` where
    mask[b]; every leaf has the batch leading."""
    if isinstance(new, tuple):
        parts = [_select(mask, n, o) for n, o in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    return torch.where(mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def _compact(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Left-compact the non-negative entries of each row: (ids, counts)."""
    keep = ids >= 0
    return compact_left(ids, keep, -1), keep.sum(1)


class StreamingRecognizer:
    """Chunked online inference over a trained CTC model.

    Usage:
        rec = StreamingRecognizer(cfg, model)
        st = rec.init(batch)
        for chunk in audio_chunks:          # [B, chunk_samples] each
            st, ids, counts = rec.step(st, chunk)
        st, ids, counts = rec.finish(st)

    Each ``step``/``finish`` returns up to chunk_frames // subsample new
    token ids per stream, left-compacted and padded with -1, as tensors on
    the recognizer's device; ``counts[b]`` says how many are valid. Audio
    arrives in exact chunks (pad the tail with zeros: the offline path
    pads the same way). In beam mode ``finish()`` returns ``(state, ids
    [B, max_label_len], lengths [B])``, the complete best-beam transcript.

    ``model`` is an encoder of ``uasr_torch.models`` holding the weights;
    it is moved to ``device`` (default CUDA; raises without a card)."""

    def __init__(self, cfg: Config, model: torch.nn.Module, chunk_frames: int | None = None,
                 lookback_frames: int | None = None, approx_context: bool = False,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model.to(self.device).eval()
        self.fe = frontend_state_from_config(cfg.frontend, device=self.device)
        # merged-stream checkpoints (gan.merge_repeats): greedy decode of the
        # merged stream == a blank-dropping repeat collapse of the raw frame
        # argmaxes, so only the emission rule changes
        self.collapse = "ctc"
        if cfg.train.mode in ("gan", "eodm", "gan+eodm") and cfg.gan.merge_repeats:
            if cfg.gan.segmenter != "none":
                raise ValueError(
                    "streaming serving supports merge_repeats but not gan.segmenter=kmeans "
                    "(segment pooling needs the whole utterance)")
            if cfg.ctc.use_beam:
                raise ValueError(
                    "streaming beam search runs on the raw frame stream; a merge_repeats "
                    "checkpoint's train-eval representation is the merged stream — use "
                    "greedy streaming (exact) or offline beam decode")
            self.collapse = "merge"
        # causal recurrent encoders carry their own state: no window, no
        # receptive-field bound; lc_bigru emits num_gru_layers chunks late
        self.recurrent = cfg.model.encoder in ("uni_gru", "lc_bigru")
        self.delay = cfg.model.num_gru_layers if cfg.model.encoder == "lc_bigru" else 0
        self.approx = False
        if self.recurrent:
            half, sub = 0, encoder_time_subsample(cfg.model)
        else:
            try:
                half, sub = streaming_receptive_field(cfg.model)
            except ValueError:
                if not approx_context:
                    raise
                # window-bounded streaming of an unbounded-context encoder:
                # left context bounded by the lookback, right by one chunk
                half, sub = 0, encoder_time_subsample(cfg.model)
                self.approx = True
        self.subsample = sub
        C = chunk_frames or cfg.frontend.streaming_chunk_frames or 64
        if cfg.model.encoder == "lc_bigru" and C != cfg.model.lc_chunk * sub:
            # the backward windows must be the training windows
            raise ValueError(
                "lc_bigru streams exactly only on its training chunk grid: chunk_frames must "
                f"be lc_chunk * stride = {cfg.model.lc_chunk} * {sub} = "
                f"{cfg.model.lc_chunk * sub}, got {C}")
        if C % sub:
            raise ValueError(f"chunk ({C}) must be a multiple of the encoder subsampling ({sub})")
        # lookback: at least the receptive field (approx: 4 chunks), rounded
        # UP to a chunk multiple so the window fills exactly before it rolls
        want_lb = lookback_frames or (4 * C if self.approx else half)
        Lb = 0 if self.recurrent else -(-max(want_lb, 1) // C) * C
        if C < half:
            raise ValueError(
                f"chunk_frames {C} < receptive-field half-width {half}: the decoded region "
                "would need context beyond the window")
        if Lb < half:
            raise ValueError(f"lookback_frames {Lb} < receptive-field half-width {half}")
        if cfg.frontend.cmvn != "streaming":
            raise ValueError(
                "online serving needs frontend.cmvn: streaming (causal running stats); got "
                f"{cfg.frontend.cmvn!r}: offline CMVN modes read the whole utterance")
        if cfg.frontend.downsample != 1 or cfg.frontend.splice_left or cfg.frontend.splice_right:
            raise ValueError(
                "streaming serving supports downsample=1 / no splicing (the chunked frontend "
                "emits frame-rate features)")
        self.chunk = C
        self.lookback = Lb
        self.window = Lb + 2 * C
        self.blank = cfg.ctc.blank_id
        self.use_beam = cfg.ctc.use_beam
        self.beam_width = cfg.ctc.beam_width
        self.max_tokens = cfg.data.max_label_len
        self.lm_table, self.lm_order = None, 0
        if self.use_beam and cfg.ctc.lm_path:
            V = cfg.dim_output
            lm = load_decode_table(cfg.ctc.lm_path, V, lambda shape: (
                f"ctc.lm_path table shape {shape} does not match vocab ({V} tokens): "
                f"expected {(V + 1, V)} (bigram) or {(V + 1, V + 1, V)} (trigram)"))
            self.lm_order = lm.ndim
            self.lm_table = torch.as_tensor(lm.reshape(-1, V), device=self.device)
        self.chunk_samples = C * cfg.frontend.frame_shift
        self._templates: dict[int, RecognizerState] = {}

    # ---- public API

    def init(self, batch: int, audio_lengths=None):
        """Fresh state for ``batch`` parallel streams. With
        ``audio_lengths`` ([batch] samples), decoding freezes per stream at
        its own audio end, as the offline decode's length masking does;
        omit it for open-ended streams."""
        dev = self.device
        if audio_lengths is None:
            valid = torch.full((batch,), _OPEN, dtype=torch.long, device=dev)
        else:
            fs = self.cfg.frontend.frame_shift
            valid = (_as_tensor(audio_lengths, torch.long, dev) + fs - 1) // fs
        Wb, L = self.beam_width, self.max_tokens
        if self.recurrent:
            make = lc_initial_carry if self.delay else uni_gru_initial_carry
            rbase = RecurrentState(
                frontend=init_stream_state(batch, self.cfg.frontend, device=dev),
                carry=make(self.cfg.model, batch, device=dev),
                n_frames=torch.zeros(batch, dtype=torch.long, device=dev),
                prev_id=torch.full((batch,), self.blank, dtype=torch.long, device=dev),
                valid_frames=valid,
            )
            if not self.use_beam:
                return rbase
            return BeamRecurrentState(
                *rbase,
                beam=beam_init(batch, Wb, dev),
                prefix=torch.full((batch, Wb, L), -1, dtype=torch.int32, device=dev),
                prefix_len=torch.zeros(batch, Wb, dtype=torch.long, device=dev),
            )
        base = RecognizerState(
            frontend=init_stream_state(batch, self.cfg.frontend, device=dev),
            feat_buf=torch.zeros(batch, self.window, self.cfg.frontend.num_mel_bins, device=dev),
            n_frames=torch.zeros(batch, dtype=torch.long, device=dev),
            prev_id=torch.full((batch,), self.blank, dtype=torch.long, device=dev),
            valid_frames=valid,
        )
        if not self.use_beam:
            return base
        return BeamRecognizerState(
            *base,
            beam=beam_init(batch, Wb, dev),
            prefix=torch.full((batch, Wb, L), -1, dtype=torch.int32, device=dev),
            prefix_len=torch.zeros(batch, Wb, dtype=torch.long, device=dev),
        )

    def step(self, state, audio_chunk):
        """Consume chunk_frames * frame_shift samples per stream; emit the
        tokens of the PREVIOUS chunk's region (none on the first call)."""
        self._check_chunk(audio_chunk)
        with torch.inference_mode():
            return self._step_impl(state, _as_tensor(audio_chunk, torch.float32, self.device))

    def finish(self, state):
        """Decode the final region (the last chunk received)."""
        with torch.inference_mode():
            return self._finish_impl(state)

    # ---- dynamic-batching primitives (tools/serve_daemon.py)
    #
    # Slots join, idle and leave at different times; every per-stream
    # state leaf (n_frames included) is per slot, so slot b's trajectory is
    # independent of every other slot's.

    def _check_chunk(self, audio_chunk) -> None:
        if audio_chunk.shape[-1] != self.chunk_samples:
            raise ValueError(f"chunk must be exactly {self.chunk_samples} samples "
                             f"({self.chunk} frames), got {audio_chunk.shape[-1]}")

    def _template(self, batch: int):
        if batch not in self._templates:
            self._templates[batch] = self.init(batch)
        return self._templates[batch]

    def _upload(self, audio_chunks, mask, stamp_mask, stamp_samples):
        """One host->device copy: the chunks with mask, stamp mask and
        stamped samples bit-cast into three trailing float32 columns
        (``h2d_bytes`` off the host). Returns (chunks, mask, stamp mask,
        stamped frame caps)."""
        self._check_chunk(audio_chunks)
        with profiling.span("stream.upload"):
            B = len(mask)
            aux = np.zeros((B, 3), np.int32)
            aux[:, 0] = np.asarray(mask, bool)
            if stamp_mask is not None:
                aux[:, 1] = np.asarray(stamp_mask, bool)
                aux[:, 2] = np.asarray(stamp_samples, np.int64).clip(0, 2 ** 31 - 1)
            packed = np.concatenate([np.asarray(audio_chunks, np.float32),
                                     aux.view(np.float32)], 1)
            if self.device.type != "cpu":
                profiling.count("h2d_bytes", packed.nbytes)
            packed = torch.from_numpy(packed).to(self.device)
        S = self.chunk_samples
        aux_d = packed[:, S:].contiguous().view(torch.int32).long()
        fs = self.cfg.frontend.frame_shift
        return packed[:, :S], aux_d[:, 0] != 0, aux_d[:, 1] != 0, (aux_d[:, 2] + fs - 1) // fs

    def _masked_step(self, state, chunks, mask, smask, frames):
        state = state._replace(valid_frames=torch.where(smask, frames, state.valid_frames))
        new, ids, counts = self._step_impl(state, chunks)
        kept = self._select_slots(mask, new, state)
        counts = torch.where(mask, counts, 0)
        return kept, torch.cat([ids, counts[:, None]], 1).to(torch.int32)

    def masked_step(self, state, audio_chunks, mask, stamp_mask=None, stamp_samples=None,
                    packed=False):
        """Step only the slots with mask[b]; the others keep their state
        bit for bit and report 0 tokens. stamp_mask/stamp_samples stamp
        those slots' utterance length (set_valid_samples) before the step.
        Returns (state, ids [B, K], counts [B]) as numpy, or with
        ``packed`` (state, [B, K+1] int32 device tensor, column K = count)."""
        with profiling.span("stream.tick"):
            with torch.inference_mode():
                chunks, m, smask, frames = self._upload(audio_chunks, mask, stamp_mask,
                                                        stamp_samples)
                kept, out = self._masked_step(state, chunks, m, smask, frames)
            if packed:
                return kept, out
            with profiling.span("stream.readback"):
                o = out.cpu().numpy()
        return kept, o[:, :-1], o[:, -1]

    def masked_step_and_finish(self, state, audio_chunks, mask, finish_mask, stamp_mask=None,
                               stamp_samples=None):
        """masked_step and finish_and_reset over DISJOINT slot sets in one
        call (the daemon's finalize tick). Returns (state, step_out
        [B, K+1], finish_out [B, Kf+1]) as packed device tensors."""
        with profiling.span("stream.tick"), torch.inference_mode():
            chunks, m, smask, frames = self._upload(audio_chunks, mask, stamp_mask,
                                                    stamp_samples)
            kept, step_out = self._masked_step(state, chunks, m, smask, frames)
            kept, fin_out = self._finish_and_reset(kept, finish_mask)
        return kept, step_out, fin_out

    def _finish_and_reset(self, state, mask):
        with profiling.span("stream.finish", device=self.device):
            mask = _as_tensor(mask, torch.bool, self.device)
            _fin, ids, counts = self._finish_impl(state)
            kept = self._select_slots(mask, self._template(len(mask)), state)
            return kept, torch.cat([ids, counts[:, None].to(ids.dtype)], 1).to(torch.int32)

    def finish_and_reset(self, state, mask, packed=False):
        """Decode the masked slots' final region AND re-initialise them for
        the next client: returns (state, final_ids, final_counts), or with
        ``packed`` (state, [B, K+1] device tensor). Unmasked slots keep
        their state bit for bit (their outputs are meaningless)."""
        with profiling.span("stream.tick"):
            with torch.inference_mode():
                kept, out = self._finish_and_reset(state, mask)
            if packed:
                return kept, out
            with profiling.span("stream.readback"):
                o = out.cpu().numpy()
        return kept, o[:, :-1], o[:, -1]

    def reset_slots(self, state, mask):
        """``state`` with the masked slots re-initialised (fresh open-ended
        streams)."""
        mask = _as_tensor(mask, torch.bool, self.device)
        return self._select_slots(mask, self._template(len(mask)), state)

    def set_valid_samples(self, state, mask, samples):
        """Stamp the masked slots' utterance length in samples, so the
        tail's zero padding is never decoded as speech."""
        fs = self.cfg.frontend.frame_shift
        mask = _as_tensor(mask, torch.bool, self.device)
        frames = (_as_tensor(samples, torch.long, self.device) + fs - 1) // fs
        return state._replace(valid_frames=torch.where(mask, frames, state.valid_frames))

    # ---- internals

    def _select_slots(self, mask, new, old):
        """Per-slot select: slot b takes ``new`` where mask[b]. Every leaf
        has the batch leading except ``uni_gru``'s GRU state [L, B, H]."""
        if not (self.recurrent and not self.delay):
            return _select(mask, new, old)
        tail = _select(mask, new.carry[0], old.carry[0])
        h = torch.where(mask[None, :, None], new.carry[1], old.carry[1])
        rest = _select(mask, new._replace(carry=()), old._replace(carry=()))
        return rest._replace(carry=(tail, h))

    def _push(self, buf, n_prev, feats):
        """Append a chunk of frames, left-aligned; roll once full. n_prev is
        per slot, and only takes multiples of C, so the insert row is
        min(n_prev, W - C) and a rolling slot always shifts one chunk."""
        C, W = self.chunk, self.window
        B, _, D = buf.shape
        pos = torch.clamp(n_prev, max=W - C)[:, None]  # [B, 1] insert row
        rolling = (n_prev + C > W)[:, None, None]
        w = torch.arange(W, device=buf.device)[None, :]
        old_rows = torch.where(rolling, torch.roll(buf, -C, 1), buf)
        fidx = torch.clamp(w - pos, 0, C - 1)
        feat_rows = feats.gather(1, fidx[..., None].expand(B, W, D))
        in_feat = (w >= pos) & (w < pos + C)
        return torch.where(in_feat[..., None], feat_rows, old_rows)

    def _decode_region_logits(self, buf, n, region_start, valid_frames):
        """Encode the window; return the logits of feature frames
        [region_start, region_start + chunk). Window rows past a stream's
        own utterance end are masked by the encoder's length handling."""
        C, W, s = self.chunk, self.window, self.subsample
        with profiling.span("stream.encoder"):
            valid = torch.clamp(n, max=W)
            a = torch.clamp(n - W, min=0)  # absolute frame index of buffer row 0
            lengths = torch.minimum(torch.clamp(valid_frames - a, 0, W), valid)
            logits, _ = self.model(buf, lengths)
            off = torch.div(region_start - a, s, rounding_mode="floor")
            idx = off[:, None] + torch.arange(C // s, device=buf.device)[None, :]
            return logits.gather(1, idx[..., None].expand(-1, -1, logits.shape[-1]))

    def _emit(self, ids, prev_id, active):
        """Greedy collapse with the carried previous id: (ids [B, K]
        left-compacted, -1 padded, counts, new prev). ``collapse="ctc"``: a
        blank resets the repeat carry and prev is the last raw argmax.
        ``collapse="merge"``: blanks are dropped without resetting it, so
        blank-separated repeats emit once, and prev is the last non-blank
        id."""
        if self.collapse == "merge":
            B, K = ids.shape
            ids = torch.where(active, ids, self.blank)
            arr = torch.cat([prev_id[:, None], ids], 1)
            slot = torch.arange(K + 1, device=ids.device)[None, :].expand(B, -1)
            # index of the last non-blank up to each slot (the carry included)
            lastnb = torch.cummax(torch.where(arr != self.blank, slot, -1), 1).values
            prev_nb = torch.where(lastnb[:, :-1] >= 0,
                                  arr.gather(1, lastnb[:, :-1].clamp(min=0)), self.blank)
            keep = (ids != self.blank) & (ids != prev_nb)
            last = lastnb[:, -1:]
            new_prev = torch.where(last >= 0, arr.gather(1, last.clamp(min=0)), self.blank)[:, 0]
            return compact_left(ids, keep, -1), keep.sum(1), new_prev
        prev_shift = torch.cat([prev_id[:, None], ids[:, :-1]], 1)
        keep = (ids != prev_shift) & (ids != self.blank) & active
        new_prev = torch.where(active[:, 0], ids[:, -1], prev_id)
        return compact_left(ids, keep, -1), keep.sum(1), new_prev

    def _advance_beam(self, state, region_logits, can, region_logit_start):
        """Evolve the carried beam over the region's logits; rows past
        their utterance end freeze (all rows when ``can`` is false)."""
        with profiling.span("stream.beam"):
            B, K, V = region_logits.shape
            s = self.subsample
            logp = torch.log_softmax(region_logits.float(), -1)
            vlog = (state.valid_frames + s - 1) // s  # frame cap -> logits cap
            lengths = torch.where(can, torch.clamp(vlog - region_logit_start, 0, K), 0)
            return beam_advance(state.beam, state.prefix, state.prefix_len, logp, lengths,
                                self.blank, self.lm_table, self.lm_order,
                                self.cfg.ctc.lm_weight, self.cfg.ctc.lm_bonus)

    def _region(self, state, buf, n, start, can):
        """Decode one region: (region logits, ids, counts, prev)."""
        region = self._decode_region_logits(buf, n, start, state.valid_frames)
        ids = region.argmax(-1)
        K = ids.shape[1]
        s = self.subsample
        pos = torch.div(start, s, rounding_mode="floor")[:, None] + torch.arange(
            K, device=ids.device)[None, :]
        vlog = (state.valid_frames + s - 1) // s
        active = can[:, None] & (pos < vlog[:, None])
        out, counts, prev = self._emit(ids, state.prev_id, active)
        return region, out, counts, prev

    def _recurrent_region(self, state, feats, a, carry, prev):
        """One encoder step of the recurrent path on feature frames starting
        at a [B]: (logits, new carry, emitted region's first frame, ids,
        counts, new prev id, can)."""
        C, s = self.chunk, self.subsample
        with profiling.span("stream.encoder"):
            if self.delay:
                logits, new_carry = self.model.step(feats, a, state.valid_frames, carry)
                estart = a - self.delay * C  # emitted region's first frame
            else:
                fv = torch.clamp(state.valid_frames - a, 0, C)
                logits, new_carry = self.model.step(feats, fv, carry)
                estart = a
        ids = logits.argmax(-1)
        K = ids.shape[1]
        can = estart >= 0
        pos = (torch.clamp(estart, min=0) // s)[:, None] + torch.arange(K, device=ids.device)
        vlog = (state.valid_frames + s - 1) // s
        active = can[:, None] & (pos < vlog[:, None])
        out, counts, new_prev = self._emit(ids, prev, active)
        return logits, new_carry, estart, out, counts, new_prev, can

    def _step_recurrent(self, state, audio_chunk):
        """Frontend chunk -> encoder step with the carried state -> tokens:
        uni_gru's of this chunk, lc_bigru's of the chunk ``delay`` back
        (none until its layer pipeline fills)."""
        with profiling.span("stream.frontend"):
            fstate, feats = stream_chunk(state.frontend, audio_chunk, self.fe,
                                         self.cfg.frontend)
        a = state.n_frames
        logits, carry, estart, out, counts, prev, can = self._recurrent_region(
            state, feats, a, state.carry, state.prev_id)
        n = a + self.chunk
        if not self.use_beam:
            return RecurrentState(fstate, carry, n, prev, state.valid_frames), out, counts
        beam, prefix, plen = self._advance_beam(state, logits, can,
                                                torch.clamp(estart, min=0) // self.subsample)
        return (BeamRecurrentState(fstate, carry, n, prev, state.valid_frames, beam, prefix,
                                   plen), out, counts)

    def _finish_recurrent(self, state):
        """uni_gru decoded every chunk on arrival: greedy has nothing to
        flush and beam reads out the best transcript. lc_bigru flushes its
        ``delay``-chunk lag with zero-input steps (the flushed windows clamp
        at each stream's valid length, as the offline windows do); greedy
        returns the flushed tokens left-compacted in one row."""
        B = state.prev_id.shape[0]
        K = self.chunk // self.subsample
        if not self.delay and not self.use_beam:
            return (state, torch.full((B, K), -1, dtype=torch.long, device=self.device),
                    torch.zeros(B, dtype=torch.long, device=self.device))
        beam = state
        if self.delay:
            zeros = torch.zeros(B, self.chunk, self.cfg.frontend.num_mel_bins,
                                device=self.device)
            carry, nf, prev = state.carry, state.n_frames, state.prev_id
            outs = []
            for _ in range(self.delay):
                logits, carry, estart, out, _c, prev, can = self._recurrent_region(
                    state, zeros, nf, carry, prev)
                outs.append(out)
                if self.use_beam:
                    b, pre, plen = self._advance_beam(
                        beam, logits, can, torch.clamp(estart, min=0) // self.subsample)
                    beam = beam._replace(beam=b, prefix=pre, prefix_len=plen)
                nf = nf + self.chunk
            if not self.use_beam:
                ids, counts = _compact(torch.cat(outs, 1))
                return state._replace(prev_id=prev), ids, counts
        best = _logaddexp(beam.beam.p_b, beam.beam.p_nb).argmax(1)
        final = beam.prefix.gather(1, best[:, None, None].expand(-1, 1, beam.prefix.shape[2]))
        return state, final[:, 0], beam.prefix_len.gather(1, best[:, None])[:, 0]

    def _step_impl(self, state, audio_chunk):
        if self.recurrent:
            return self._step_recurrent(state, audio_chunk)
        C = self.chunk
        with profiling.span("stream.frontend"):
            fstate, feats = stream_chunk(state.frontend, audio_chunk, self.fe,
                                         self.cfg.frontend)
        buf = self._push(state.feat_buf, state.n_frames, feats)
        n = state.n_frames + C  # per-slot stream age
        # the previous chunk's region once it has C frames of real right
        # context; before that (first call) nothing
        can = n >= 2 * C
        start = torch.clamp(n - 2 * C, min=0)
        region, out, counts, prev = self._region(state, buf, n, start, can)
        if not self.use_beam:
            return RecognizerState(fstate, buf, n, prev, state.valid_frames), out, counts
        beam, prefix, plen = self._advance_beam(state, region, can, start // self.subsample)
        return (BeamRecognizerState(fstate, buf, n, prev, state.valid_frames, beam, prefix,
                                    plen), out, counts)

    def _finish_impl(self, state):
        if self.recurrent:
            return self._finish_recurrent(state)
        C = self.chunk
        n = state.n_frames
        can = n >= C
        start = torch.clamp(n - C, min=0)
        region, out, counts, prev = self._region(state, state.feat_buf, n, start, can)
        if not self.use_beam:
            return state._replace(prev_id=prev), out, counts
        # beam mode: the complete best transcript (step()'s greedy partials
        # were provisional)
        beam, prefix, plen = self._advance_beam(state, region, can, start // self.subsample)
        best = _logaddexp(beam.p_b, beam.p_nb).argmax(1)  # [B]
        final = prefix.gather(1, best[:, None, None].expand(-1, 1, prefix.shape[2]))[:, 0]
        final_len = plen.gather(1, best[:, None])[:, 0]
        new = BeamRecognizerState(state.frontend, state.feat_buf, n, prev, state.valid_frames,
                                  beam, prefix, plen)
        return new, final, final_len
