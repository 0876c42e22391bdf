"""Rank-side code of the CPU tests' gloo groups (tests/test_torch_parallel.py).

``python -m tests._torch_dist_worker SPEC OUT`` runs as one rank of a
group started by ``uasr_torch.parallel.launch``: it joins the gloo group,
reads the pickled case list SPEC (port configs, weights converted from
the JAX package's initial state, numpy batches), runs each case on the
mesh it names and pickles this rank's results to ``OUT.rank<r>``. Each
result holds whole tensors (gathered over the model group) as numpy
arrays. It imports torch, numpy and the port, never jax or the JAX
package, and runs one intra-op thread.
"""

import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from uasr_torch import pretrain, train
from uasr_torch.parallel import collectives as C
from uasr_torch.parallel import init_distributed, make_mesh, shard_batch


def _np(d: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def _aux(aux: dict) -> dict:
    return {k: float(v) for k, v in aux.items()}


def _load(model, plan, weights: dict) -> None:
    sd = {k: torch.tensor(v) for k, v in weights.items()}
    model.load_state_dict(sd if plan is None else plan.shard(sd))


def _record_clip_norms(opt) -> list:
    """The global norm of each gradient ``opt`` clips (with ``grad_accum``
    the accumulated mean's, before the clip), appended as it runs."""
    norms, inner = [], opt._update

    def recorded(grads, opt_state, params):
        out = inner(grads, opt_state, params)
        norms.append(float(out[1]))
        return out

    opt._update = recorded
    return norms


def ctc(mesh, case):
    """CTCTrainer steps (CTC or frame-CE, ``grad_accum`` micro-batches
    included) from the given weights; with ``ckpt_dir`` rank 0 saves the
    whole state after the last step."""
    tr = train.CTCTrainer(case["cfg"], device="cpu", mesh=mesh)
    _load(tr.model, tr.plans[0], case["weights"])
    clip_norms = _record_clip_norms(tr.optimizer)
    state = tr.init_state()
    auxes = []
    for b in case["batches"]:
        state, aux = tr.train_step(state, shard_batch(b, mesh))
        auxes.append(_aux(aux))
    whole = tr.whole_state(state)
    if case.get("ckpt_dir"):
        from uasr_torch.checkpoint import CheckpointManager

        if mesh.is_writer:
            CheckpointManager(case["ckpt_dir"]).save(state.step, whole)
        mesh.barrier()
    return {"params": _np(whole.params), "aux": auxes, "step": state.step,
            "clip_norms": clip_norms,
            "sharded": sorted(tr.plans[0].dims) if tr.plans[0] is not None else []}


def forward(mesh, case):
    """The model's logits on the whole batch (every rank the same rows)."""
    tr = train.CTCTrainer(case["cfg"], device="cpu", mesh=mesh)
    _load(tr.model, tr.plans[0], case["weights"])
    audio, alen = (torch.as_tensor(np.asarray(x)) for x in case["batch"][:2])
    with torch.no_grad():
        feats, flen = tr._feats(audio.float(), alen.long())
        logits, _ = tr.model(feats, flen)
    return {"logits": logits.numpy()}


def gan(mesh, case):
    """``disc_steps`` critic steps, then a generator step, with the given
    ε (global-batch draws) and batches."""
    from uasr_torch.ops.eodm import device_ngram_tables

    cfg = case["cfg"]
    tables = device_ngram_tables(cfg.eodm, case["text"], "cpu") if case["eodm"] else None
    tr = train.GANTrainer(cfg, device="cpu", tables=tables, mesh=mesh)
    _load(tr.gen, tr.plans[0], case["g_weights"])
    _load(tr.disc, tr.plans[1], case["d_weights"])
    state = tr.init_state()
    auxes = []
    for a, t, eps in zip(case["d_audio"], case["d_text"], case["eps"]):
        state, aux = tr.d_step(state, shard_batch(a, mesh), shard_batch(t, mesh),
                               eps=torch.tensor(eps))
        auxes.append(_aux(aux))
    state, aux = tr.g_step(state, shard_batch(case["g_audio"], mesh))
    auxes.append(_aux(aux))
    whole = tr.whole_state(state)
    return {"g_params": _np(whole.g_params), "d_params": _np(whole.d_params), "aux": auxes}


def eodm(mesh, case):
    cfg = case["cfg"]
    tr = train.EODMTrainer(cfg, case["text"], device="cpu", mesh=mesh)
    _load(tr.gen, tr.plans[0], case["weights"])
    state, aux = tr.train_step(tr.init_state(), shard_batch(case["batch"], mesh))
    return {"params": _np(tr.whole_state(state).params), "aux": [_aux(aux)]}


def ssl(mesh, case):
    """SSLTrainer's dev eval of a ragged batch, then one step; the negatives
    are the given global-batch draws (the eval's padded to the split),
    cut to this rank's rows."""
    tr = pretrain.SSLTrainer(case["cfg"], device="cpu", mesh=mesh)
    _load(tr.model, tr.plans[0], case["weights"])
    state = tr.init_state()
    dev_negs = torch.as_tensor(case["dev_negatives"]).long()
    pretrain.sample_negatives = lambda g, flen, num: C.local_rows(dev_negs)
    dev = tr.evaluate(state.params, [case["dev"]])
    negs = torch.as_tensor(case["negatives"]).long()
    pretrain.sample_negatives = lambda g, flen, num: C.local_rows(negs)
    state, aux = tr.train_step(state, shard_batch(case["batch"], mesh))
    return {"params": _np(tr.whole_state(state).params), "aux": [_aux(aux)], "dev": dev}


def decode(mesh, case):
    """run_inference over the mesh; rank 0 writes ``hyp_path``."""
    from uasr_torch import infer
    from uasr_torch.frontend.features import frontend_state_from_config

    cfg = case["cfg"]
    tr = train.CTCTrainer(cfg, device="cpu", mesh=mesh)
    _load(tr.model, tr.plans[0], case["weights"])
    res = infer.run_inference(cfg, tr.model, frontend_state_from_config(cfg.frontend, device="cpu"),
                              case["batches"], vocab=case["vocab"], hyp_path=case["hyp_path"],
                              device="cpu", mesh=mesh)
    return {"res": {k: res[k] for k in ("errors", "ref_tokens", "per")},
            "impl": infer.LAST_BEAM_IMPL}


def dryrun(mesh, case):
    """The multichip dry run's six steps on this group's (2, 2) mesh."""
    from uasr_torch.tools.dryrun_multichip import run_steps

    return run_steps(mesh, torch.device("cpu"))


def main():
    spec_path, out_path = sys.argv[1:3]
    torch.set_num_threads(1)
    init_distributed("cpu")
    with open(spec_path, "rb") as f:
        cases = pickle.load(f)
    meshes: dict = {}
    results = {}
    for name, case in cases:
        m = case["cfg"].parallel.model_parallel if "cfg" in case else case["model_parallel"]
        if m not in meshes:
            meshes[m] = make_mesh(m, "cpu")
        torch.manual_seed(0)
        results[name] = globals()[case["kind"]](meshes[m], case)
    with open(f"{out_path}.rank{dist.get_rank()}", "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
