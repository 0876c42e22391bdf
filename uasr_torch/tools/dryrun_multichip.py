"""Multichip dry run (counterpart of ``__graft_entry__.py``'s
``dryrun_multichip``): six training steps on a ``(data, model) = (n / 2,
2)`` mesh at tiny shapes, each of which must return a finite loss:

- the CTC step of a conv_bigru (K2 / K2-bwd, K3 / K3-bwd on the card);
- a GAN critic step (the gradient penalty's double backward) and a
  generator step of the classifier;
- an EODM step;
- a transformer CTC step with ``model.sequence_shard`` (d = 64, 4 heads:
  K6 / K6-bwd on each rank's 2 heads of 16, the kernel's smallest head
  size);
- an SSL contrastive step (the context GRU through K5 / K5-bwd).

    python -m uasr_torch.tools.dryrun_multichip --ranks 4 [--device cuda|cpu] [--backend gloo]

starts ``--ranks`` processes (``parallel.launch``) and prints rank 0's
losses and kernel launches as one JSON line. ``--ranks`` must be even.
With a card for every rank, rank r runs on ``cuda:r`` (NCCL by default);
with fewer cards every rank shares ``cuda:0``, which only ``--backend
gloo`` takes (NCCL refuses two ranks on one device). Without a card pass
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

V = 16


def _cfg(device: str):
    from uasr_torch import config as tc

    on_card = device.startswith("cuda")
    return tc.Config(
        name="dryrun",
        frontend=tc.FrontendConfig(num_mel_bins=16, cmvn="utterance"),
        model=tc.ModelConfig(encoder="conv_bigru", hidden_size=32, num_gru_layers=1,
                             conv_channels=8, num_conv_layers=2, conv_time_stride=2,
                             gru_pallas=True, attn_pallas=True),
        ctc=tc.CTCConfig(use_pallas=True),
        ssl=tc.SSLConfig(conv_channels=(8, 8, 16), conv_kernels=(16, 10, 8),
                         conv_strides=(8, 5, 4), context_hidden=16, predict_steps=2,
                         num_negatives=8, context_pallas=on_card),
        train=tc.TrainConfig(total_steps=1, lr=1e-3),
        parallel=tc.ParallelConfig(model_parallel=2),
        vocab_size=V,
    )


def launches() -> dict:
    """This rank's kernel launches so far, by kernel (the wrappers' counts)."""
    from uasr_torch.frontend import cuda_frontend
    from uasr_torch.models import cuda_gru
    from uasr_torch.ops import cuda_attention, cuda_ctc

    return {"K1": cuda_frontend.LAUNCHES, "K2": cuda_gru.LAUNCHES,
            "K2-bwd": cuda_gru.LAUNCHES_BWD, "K3": cuda_ctc.LAUNCHES,
            "K3-bwd": cuda_ctc.LAUNCHES_BWD, "K5": cuda_gru.LAUNCHES_GRU,
            "K5-bwd": cuda_gru.LAUNCHES_GRU_BWD, "K6": cuda_attention.LAUNCHES_ATTN,
            "K6-bwd": cuda_attention.LAUNCHES_ATTN_BWD}


def run_steps(mesh, dev) -> dict:
    """The six steps on ``mesh`` (model dim 2) on this rank's device
    ``dev``; returns their losses, the mesh and this rank's launches.
    Raises on a non-finite loss."""
    from uasr_torch.data.dataset import Batch, TextBatch
    from uasr_torch.parallel import shard_batch
    from uasr_torch.pretrain import SSLTrainer
    from uasr_torch.train import CTCTrainer, EODMTrainer, GANTrainer

    cfg = _cfg(dev.type)
    B = mesh.data_size * 2
    L = 1600 * 4  # 0.4 s
    rng = np.random.RandomState(0)
    batch = Batch((rng.randn(B, L) * 0.1).astype(np.float32), np.full((B,), L, np.int32),
                  rng.randint(1, V, size=(B, 6)).astype(np.int32), np.full((B,), 6, np.int32))
    text = TextBatch(rng.randint(1, V, size=(B, 6)).astype(np.int32), np.full((B,), 6, np.int32))
    sb, st = shard_batch(batch, mesh), shard_batch(text, mesh)
    out = {}

    ctc = CTCTrainer(cfg, device=dev, mesh=mesh)
    _, aux = ctc.train_step(ctc.init_state(), sb)
    out["ctc_loss"] = float(aux["ctc_loss"])

    model = dataclasses.replace(cfg.model, encoder="classifier", classifier_hidden=32,
                                disc_channels=16, disc_layers=2)
    gcfg = cfg.replace(model=model)
    gan = GANTrainer(gcfg, device=dev, mesh=mesh)
    gstate = gan.init_state()
    gstate, d_aux = gan.d_step(gstate, sb, st)
    gstate, g_aux = gan.g_step(gstate, sb)
    out["d_loss"], out["g_loss"] = float(d_aux["d_loss"]), float(g_aux["g_loss"])

    eodm = EODMTrainer(gcfg, [[1, 2, 3, 2, 1, 3] * 3], device=dev, mesh=mesh)
    _, e_aux = eodm.train_step(eodm.init_state(), sb)
    out["eodm_loss"] = float(e_aux["eodm_loss"])

    # d = 64: 4 heads of 16, K6's smallest head size, 2 per model rank
    tmodel = dataclasses.replace(cfg.model, encoder="transformer", hidden_size=64,
                                 transformer_layers=2, num_heads=4, sequence_shard=True)
    tt = CTCTrainer(cfg.replace(model=tmodel), device=dev, mesh=mesh)
    _, t_aux = tt.train_step(tt.init_state(), sb)
    out["transformer_ctc_loss"] = float(t_aux["ctc_loss"])

    ssl = SSLTrainer(cfg.replace(train=dataclasses.replace(cfg.train, mode="ssl")),
                     device=dev, mesh=mesh)
    _, s_aux = ssl.train_step(ssl.init_state(), sb)
    out["nce_loss"] = float(s_aux["nce_loss"])
    bad = {k: v for k, v in out.items() if not np.isfinite(v)}
    if bad:
        raise SystemExit(f"non-finite losses on rank {mesh.rank}: {bad}")
    out.update(ranks=mesh.data_size * mesh.model_size, mesh=mesh.shape, launches=launches())
    return out


def run_rank(device: str, backend: str | None) -> dict:
    """Join the launcher's group, run the six steps, leave the group."""
    import torch

    from uasr_torch.parallel import init_distributed, local_device, make_mesh

    torch.set_num_threads(1)
    if not init_distributed(device, backend=backend):
        raise SystemExit("run under the launcher (--ranks N): WORLD_SIZE is unset")
    dev = local_device(device)
    out = run_steps(make_mesh(2, dev.type), dev)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return out


def one_card(device: str, backend: str | None, ranks: int, cards: int) -> bool:
    """Whether every rank shares card 0 (``LOCAL_RANK`` 0): only on cuda
    with fewer cards than ranks, and then only over gloo; NCCL, the cuda
    default, refuses two ranks on one device, so that raises."""
    if not device.startswith("cuda") or cards >= ranks:
        return False
    if backend != "gloo":
        raise SystemExit(f"{ranks} ranks on {cards} card(s): {backend or 'nccl'} needs a card "
                         "per rank; pass --backend gloo to run every rank on cuda:0")
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser("dryrun_multichip", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ranks", type=int, default=4, help="processes (even)")
    p.add_argument("--device", default="cuda",
                   help="cuda (rank r on cuda:r; with fewer cards than ranks every rank on "
                        "cuda:0, which needs --backend gloo) or cpu")
    p.add_argument("--backend", default=None,
                   help="process-group backend (default nccl for cuda, gloo for cpu; several "
                        "ranks on one card need gloo)")
    p.add_argument("--timeout", type=float, default=300.0, help="join timeout, seconds")
    p.add_argument("--rank-worker", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank_worker:
        res = run_rank(args.device, args.backend)
        print("DRYRUN " + json.dumps(res), flush=True)
        return 0
    if args.ranks < 2 or args.ranks % 2:
        raise SystemExit("--ranks must be even (the mesh is (ranks / 2, 2))")
    import torch

    from uasr_torch.parallel.launch import launch

    shared = one_card(args.device, args.backend, args.ranks, torch.cuda.device_count())
    cmd = ["-m", "uasr_torch.tools.dryrun_multichip", "--rank-worker", "--device", args.device]
    if args.backend:
        cmd += ["--backend", args.backend]
    outs = launch(cmd, args.ranks, timeout=args.timeout, one_device=shared)
    line = next(ln for ln in outs[0].splitlines() if ln.startswith("DRYRUN "))
    print(f"dryrun_multichip ok: {line[len('DRYRUN '):]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
