"""The mesh's checks: each task runs on every rank of a mesh (through
``Mesh.run``) or alone with ``mesh=None``, so one call of each gives the
n-rank and the world-size-1 figures to hold against each other, as the
JAX package's ``__graft_entry__.dryrun_multichip`` holds its mesh against
one device. :func:`compare` runs them all and holds them to their limits;
as a script it does so on n cards over NCCL (or n CPU ranks over gloo),
then drives the command line's run loop and ``--serve`` on the mesh::

  python -m vit_cnn_tpu_torch.tools.mesh_check --ranks 4    # 4 cards
  python -m vit_cnn_tpu_torch.tools.mesh_check --ranks 4 --cpu

The tasks:

* :func:`train_steps` — Trainer steps on given global batches: the
  global loss of each step, the state after the first and the last step,
  the summed gradients of the first, how far the ranks' parameters part
  (0: replicated), each rank's kernel launches and the host time a step;
* :func:`maps` — ``full_scene_probabilities`` at the given strides;
* :func:`resume` — a resumable file saved under the mesh, restored by a
  trainer of another seed (every tensor compared bit for bit), then one
  more step;
* :func:`moco_steps` — Pretrainer steps: losses, the queue and its
  pointer;
* :func:`poisoned_step` — a NaN in a parameter of one rank only under
  ``--debug_nans``' checks: the step raises.

A case is a dict: ``model`` (a registry name), ``scene`` (img1, img2,
gt), ``hp`` (the registry's keyword arguments), ``state`` (a state_dict,
or None for the seeded init), ``dtype`` ('float32' or 'float64'),
``device`` (of a world-size-1 run; a mesh's ranks take their own) and
``seed``. tests/test_torch_mesh.py runs them on the CPU and
``chip_smoke.py``'s mesh phase (:func:`compare`, two ranks sharing the
card) on the card.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.moco import DualModalEncoder
from ..models.registry import get_model
from ..nn.layers import init_parameters
from ..ops import _build
from ..parallel.mesh import Mesh, make_mesh
from ..pipeline.patches import (AugmentConfig, PatchPipeline,
                                interior_indices)
from ..pipeline.twoview import TwoViewPipeline
from ..train.loop import Trainer
from ..train.pretrain import Pretrainer

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _device(mesh: Optional[Mesh], case: Dict) -> torch.device:
    return mesh.device if mesh is not None else torch.device(
        case.get("device", "cpu"))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host(state) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


def trainer(mesh: Optional[Mesh], case: Dict, seed: Optional[int] = None,
            debug_nans: bool = False) -> Trainer:
    """The case's Trainer on this rank (``seed``: another than the
    case's)."""
    device = _device(mesh, case)
    dtype = DTYPES[case.get("dtype", "float32")]
    img1, img2, gt = case["scene"]
    hp_in = dict(case["hp"], debug_nans=debug_nans)
    net, _, hp = get_model(case["model"], **hp_in)
    if case.get("state") is not None:
        net.load_state_dict(case["state"])
    else:
        init_parameters(net, case.get("seed", 0))
    net.to(device=device, dtype=dtype)
    aug = AugmentConfig(flip=hp.get("flip_augmentation", False),
                        radiation=hp.get("radiation_augmentation", False),
                        mixture=hp.get("mixture_augmentation", False))
    pipe = PatchPipeline(img1, img2, gt, hp["patch_size"],
                         hp["ignored_labels"], hp["n_classes"], augment=aug,
                         device=device)
    pipe.to_compute_dtype(dtype)
    return Trainer(net, hp, pipe, seed=case.get("seed", 0) if seed is None
                   else seed, save_checkpoints=False, mesh=mesh)


def batches(case: Dict, steps: int) -> List[np.ndarray]:
    """``steps`` global batches of centers: the case's seeded shuffle of
    the train centers in turn, wrapping round."""
    hp = get_model(case["model"], **case["hp"])[2]
    indices = interior_indices(case["scene"][2], hp["patch_size"],
                               hp["ignored_labels"], "full")
    # PatchPipeline.epoch_order's permutation
    order = indices[np.random.RandomState(case.get("seed", 0)).permutation(
        len(indices))]
    b = int(hp["batch_size"])
    reps = -(-steps * b // len(order))
    flat = np.concatenate([order] * reps)
    return [flat[s * b:(s + 1) * b] for s in range(steps)]


def _step(t: Trainer, mesh: Optional[Mesh], centers: np.ndarray):
    device = t.device
    c = torch.as_tensor(centers, device=device)
    loss = t._step(c, torch.ones(len(centers), device=device),
                   torch.zeros((), device=device))
    if mesh is not None:
        mesh.sum_(loss)                       # the ranks' shares
    return float(loss)


def _per_rank(mesh: Optional[Mesh], obj) -> list:
    """Every rank's ``obj``, in rank order, on every rank."""
    if mesh is None:
        return [obj]
    return [mesh.broadcast_object(obj if r == mesh.rank else None, src=r)
            for r in range(mesh.world_size)]


def _spread(mesh: Optional[Mesh], model: torch.nn.Module) -> float:
    """max |p_r - p_0| over the ranks and every parameter and buffer."""
    if mesh is None:
        return 0.0
    worst = torch.zeros((), dtype=torch.float64, device=mesh.device)
    for t in list(model.parameters()) + list(model.buffers()):
        if t.numel():
            ref = mesh.broadcast_(t.detach().clone())
            worst = torch.maximum(worst, (t.detach().double()
                                          - ref.double()).abs().max())
    return max(float(x) for x in _per_rank(mesh, float(worst)))


def train_steps(mesh: Optional[Mesh], case: Dict, steps: int,
                grads: bool = False) -> Dict:
    """``steps`` Trainer steps on :func:`batches`; see the module doc."""
    t = trainer(mesh, case)
    device = t.device
    out = {"losses": [], "seconds": []}
    _build.launches.clear()
    for s, centers in enumerate(batches(case, steps)):
        _sync(device)
        t0 = time.perf_counter()
        out["losses"].append(_step(t, mesh, centers))
        _sync(device)
        out["seconds"].append(time.perf_counter() - t0)
        if s == 0:
            out["state_1"] = _host(t.model.state_dict())
            if grads:
                out["grads_1"] = {k: p.grad.detach().cpu().clone()
                                  for k, p in t.model.named_parameters()}
    out["launches"] = _per_rank(mesh, dict(_build.launches))
    out["state"] = _host(t.model.state_dict())
    out["spread"] = _spread(mesh, t.model)
    return out


def maps(mesh: Optional[Mesh], case: Dict, strides: Sequence[int] = (1,),
         chunk: int = 8192) -> Dict[int, np.ndarray]:
    """The case's full-scene map (eval mode, float32) at each stride."""
    from ..infer.fullscene import full_scene_probabilities

    device = _device(mesh, case)
    img1, img2, gt = case["scene"]
    net, _, hp = get_model(case["model"], **case["hp"])
    net.load_state_dict(case["state"])
    net.to(device).eval()
    return {s: full_scene_probabilities(net, img1, img2,
                                        dict(hp, test_stride=s), chunk=chunk,
                                        mesh=mesh)
            for s in strides}


def resume(mesh: Optional[Mesh], case: Dict, directory: str) -> Dict:
    """One step, ``save_resumable`` under the mesh, ``restore_resumable``
    into a trainer of another seed (its model, optimizer moments, step
    count and random streams against the saved trainer's, bit for bit,
    on every rank), then one more step on both: the losses."""
    a = trainer(mesh, case)
    first = batches(case, 2)
    _step(a, mesh, first[0])
    path = a.save_resumable(os.path.join(directory, "resume"), epoch=1)
    b = trainer(mesh, case, seed=case.get("seed", 0) + 17)
    epoch = b.restore_resumable(path)
    same = all(torch.equal(x, y) for x, y in zip(
        a.model.state_dict().values(), b.model.state_dict().values()))
    opt_a, opt_b = a.optimizer.state_dict(), b.optimizer.state_dict()
    for k, st in opt_a["state"].items():
        for name, v in st.items():
            w = opt_b["state"][k][name]
            same &= (torch.equal(v, w) if isinstance(v, torch.Tensor)
                     else v == w)
    same &= (a.steps_done == b.steps_done
             and torch.equal(a.generator.get_state(), b.generator.get_state())
             and np.array_equal(a.np_rng.get_state()[1],
                                b.np_rng.get_state()[1]))
    return {"epoch": epoch, "exact": all(_per_rank(mesh, bool(same))),
            "next_loss": _step(b, mesh, first[1]),
            "next_loss_unbroken": _step(a, mesh, first[1])}


def moco_steps(mesh: Optional[Mesh], case: Dict, steps: int,
               queue_size: int) -> Dict:
    """``steps`` MoCo pretraining steps (float32) of a DualModalEncoder
    from ``case["state"]`` on the case's scene, flip and the hp's noises
    on view 2: the global loss of each step, the queue and its
    pointer."""
    device = _device(mesh, case)
    img1, img2, gt = case["scene"]
    hp = case["hp"]
    enc = DualModalEncoder(img1.shape[-1], img2.shape[-1], embed_dim=128)
    enc.load_state_dict(case["state"])
    enc.to(device)
    aug = AugmentConfig(flip=True, radiation=hp.get("radiation", False),
                        mixture=hp.get("mixture", False))
    pipe = TwoViewPipeline(img1, img2, gt, hp["patch_size"], [0],
                           int(gt.max()) + 1, augment=aug, device=device)
    pre = Pretrainer(enc, hp, pipe, queue_size=queue_size,
                     seed=case.get("seed", 0), save_checkpoints=False,
                     mesh=mesh)
    b = int(hp["batch_size"])
    order = pipe.epoch_order(np.random.RandomState(case.get("seed", 0)))
    losses = []
    for s in range(steps):
        c = torch.as_tensor(order[s * b:(s + 1) * b], device=device)
        loss = pre._step(c, torch.ones(b, device=device),
                         torch.zeros((), device=device), hp["lr"])
        if mesh is not None:
            mesh.sum_(loss)
        losses.append(float(loss))
    return {"losses": losses, "queue": pre.moco.queue.cpu(),
            "queue_ptr": pre.moco.queue_ptr}


def poisoned_step(mesh: Optional[Mesh], case: Dict, rank: int) -> None:
    """A step under ``--debug_nans``' checks with a NaN in the first
    parameter on rank ``rank`` only: the step raises FloatingPointError
    there (a mesh ends every rank)."""
    t = trainer(mesh, case, debug_nans=True)
    if (mesh.rank if mesh is not None else 0) == rank:
        with torch.no_grad():
            next(t.model.parameters()).view(-1)[0] = float("nan")
    _step(t, mesh, batches(case, 1)[0])


#: train steps and the maps' chunk of :func:`compare` (stride 1 on a
#: 12 x 64 crop: 4 bands of 1 origin row; stride 2: 87 origins in 3
#: chunks)
STEPS, MAP_CHUNK = 3, 32


def compare(ranks: int, device: str, share: bool, case: Dict,
            map_case: Dict, moco_case: Dict, queue_size: int,
            directory: str, say: Callable = print) -> Tuple[Dict, List]:
    """World size 1 against ``ranks`` ranks (``make_mesh(ranks, device,
    share)``) on the same cases: :data:`STEPS` train steps (step-1 loss
    within 1e-5 + 1e-4 |L|, the trajectory within rtol 5e-3 / atol 1e-4,
    the BatchNorm statistics after step 1 within 1e-5 + 1e-4 |v|, the
    ranks' parameters equal), the stride-1 and stride-2 maps of
    ``map_case`` (within 1e-5 of max(1, max|map|)), a resumable round trip
    under the mesh (bit for bit, then a finite step) and one MoCo step
    (loss within 1e-3 relative, queue within 1e-6, pointer equal). Says
    each figure through ``say``; returns (the figures, the gates that
    failed)."""
    t0 = time.perf_counter()
    one = train_steps(None, case, STEPS)
    one_maps = maps(None, map_case, (1, 2), chunk=MAP_CHUNK)
    one_moco = moco_steps(None, moco_case, 1, queue_size)
    t1 = time.perf_counter()
    with make_mesh(ranks, device, share=share) as mesh:
        t2 = time.perf_counter()
        many = mesh.run(train_steps, case, STEPS)
        many_maps = mesh.run(maps, map_case, (1, 2), chunk=MAP_CHUNK)
        resumed = mesh.run(resume, case, directory)
        many_moco = mesh.run(moco_steps, moco_case, 1, queue_size)
    t3 = time.perf_counter()

    l1, ln = one["losses"], many["losses"]
    b = int(case["hp"]["batch_size"])
    say("{} {} ranks ({}), {} at batch {} split {} x {}: losses {} against "
        "world size 1 {}".format(ranks, mesh.backend, "one card" if share
                                 else device, case["model"], b, ranks,
                                 b // ranks, ln, l1))
    bad = []
    if not np.isfinite(ln).all():
        bad.append("non-finite loss")
    if abs(ln[0] - l1[0]) > 1e-5 + 1e-4 * abs(l1[0]):
        bad.append("step-1 loss {} vs {}".format(ln[0], l1[0]))
    if not np.allclose(ln, l1, rtol=5e-3, atol=1e-4):
        bad.append("trajectory {} vs {}".format(ln, l1))
    worst_s = max((float(((many["state_1"][k] - v).abs()
                          / (1e-5 + 1e-4 * v.abs())).max()), k)
                  for k, v in one["state_1"].items()
                  if k.endswith(("running_mean", "running_var")))
    say("BatchNorm statistics after step 1: worst |diff| {:.3f} of its "
        "limit 1e-5 + 1e-4 |v| ({}); the ranks' parameters part by "
        "{:g}".format(worst_s[0], worst_s[1], many["spread"]))
    if worst_s[0] > 1.0:
        bad.append("BatchNorm statistics {}".format(worst_s))
    if many["spread"] != 0.0:
        bad.append("the ranks' parameters part by {}".format(many["spread"]))
    errs = {}
    for stride in (1, 2):
        a, m = one_maps[stride], many_maps[stride]
        errs[stride] = float(np.abs(m - a).max())
        limit = 1e-5 * max(1.0, float(np.abs(a).max()))
        say("stride-{} map of a {} x {} scene (chunk {}): max|diff| {:.3e} "
            "against world size 1 (limit {:.1e})".format(
                stride, *a.shape[:2], MAP_CHUNK, errs[stride], limit))
        if not (np.isfinite(m).all() and errs[stride] <= limit
                and np.abs(a).sum()):
            bad.append("stride-{} map".format(stride))
    say("resumable file saved under the mesh: restored bit for bit {}, "
        "epoch {}, next loss {:.6f} (unbroken {:.6f})".format(
            resumed["exact"], resumed["epoch"], resumed["next_loss"],
            resumed["next_loss_unbroken"]))
    if not (resumed["exact"] and np.isfinite(resumed["next_loss"])):
        bad.append("resumable round trip")
    dl = abs(many_moco["losses"][0] - one_moco["losses"][0])
    dq = float((many_moco["queue"] - one_moco["queue"]).abs().max())
    say("MoCo step (batch {}, queue {}): loss {:.6f} / {:.6f}, queue "
        "max|diff| {:.2e}, pointer {} / {}".format(
            moco_case["hp"]["batch_size"], queue_size,
            many_moco["losses"][0], one_moco["losses"][0], dq,
            many_moco["queue_ptr"], one_moco["queue_ptr"]))
    if dl > 1e-3 * abs(one_moco["losses"][0]) or dq > 1e-6 or \
            many_moco["queue_ptr"] != one_moco["queue_ptr"]:
        bad.append("MoCo step")
    figures = {"backend": mesh.backend, "losses": ln, "losses_world_1": l1,
               "bn_worst_of_limit": worst_s[0], "spread": many["spread"],
               "map_max_abs_diff": errs, "moco_queue_max_abs_diff": dq,
               "launches": many["launches"],
               "ms_per_step_world_1": 1e3 * float(np.median(
                   one["seconds"][1:])),
               "ms_per_step": 1e3 * float(np.median(many["seconds"][1:])),
               "group_start_s": t2 - t1, "world_1_s": t1 - t0,
               "group_s": t3 - t1}
    return figures, bad


def _cases(cpu: bool, directory: str):
    """The script's cases: on the card the flagship at full width on a
    40 x 200 crop of the Synthetic scene at Houston2013 size, batch 64,
    float32, flip on; on the CPU a 17 x 21 scene of 20 + 1 bands, batch
    16."""
    from ..convert import seeded_state_dict
    from ..data import get_dataset
    from . import SCENE

    env = ({"VCT_SYN_H": "17", "VCT_SYN_W": "21", "VCT_SYN_BANDS": "20",
            "VCT_SYN_CLASSES": "5"} if cpu else SCENE)
    os.environ.update(env)
    img1, img2, gt = get_dataset("Synthetic", directory)[:3]
    device, batch = ("cpu", 16) if cpu else ("cuda", 64)
    scene = tuple(x[:40, :200] for x in (img1, img2, gt))
    hp = dict(dataset="Synthetic", n_classes=int(env["VCT_SYN_CLASSES"]),
              n_bands=(img1.shape[2], img2.shape[2]), ignored_labels=[0],
              batch_size=batch, epoch=1, flip_augmentation=True)
    case = dict(model="Multimodality_Mamba", scene=scene, hp=hp,
                state=seeded_state_dict(get_model(
                    "Multimodality_Mamba", **hp)[0], 0),
                dtype="float32", device=device, seed=0)
    map_case = dict(case, scene=tuple(x[:12, :64] for x in (img1, img2,
                                                             gt)))
    moco_case = dict(scene=scene, device=device, seed=0, state=(
        seeded_state_dict(DualModalEncoder(img1.shape[2], 1), 0)),
        hp=dict(patch_size=5 if cpu else 9, lr=5e-4, epoch=1,
                batch_size=batch, radiation=True, mixture=True))
    return case, map_case, moco_case


def _cli(ranks: int, cpu: bool, directory: str, say: Callable) -> List:
    """``run_experiments`` (EndNet, 1 run of 1 epoch) and ``--serve``
    (EndNet's seeded weights, a stride-1 and a stride-3 request) at
    ``--n_devices ranks``, the served maps against ``--no_mesh``; returns
    the gates that failed."""
    from .. import cli

    base = ["--dataset", "Synthetic", "--folder", directory, "--model",
            "EndNet", "--infer_chunk", "512"] + (["--device", "cpu"]
                                                 if cpu else [])
    bad = []
    here = os.getcwd()
    os.chdir(directory)                     # ./checkpoints
    try:
        (run,) = cli.run_experiments(cli.build_parser().parse_args(
            base + ["--n_devices", str(ranks), "--runs", "1", "--epoch",
                    "1", "--batch_size", "64", "--training_sample", "30",
                    "--out_dir", os.path.join(directory, "out"),
                    "--log_every", "0"]))
        say("run_experiments --n_devices {}: OA {:.2f}, losses {}".format(
            ranks, run["OA"], run["losses"]))
        if not np.isfinite(run["OA"]):
            bad.append("run_experiments")
        served = {}
        for flag in (["--no_mesh"], ["--n_devices", str(ranks)]):
            reqs = [{"out": os.path.join(directory, "{}{}.npy".format(
                flag[0], s)), "stride": s} for s in (1, 3)]
            out = io.StringIO()
            cli.run_serve(cli.build_parser().parse_args(
                base + ["--serve"] + flag), io.StringIO(
                    "\n".join(map(json.dumps, reqs)) + "\n"), out)
            resps = [json.loads(l) for l in out.getvalue().splitlines()]
            served[flag[0]] = [np.load(r["out"]) for r in resps
                               if r.get("ok")]
        for s, a, m in zip((1, 3), served["--no_mesh"],
                           served["--n_devices"]):
            err = float(np.abs(m - a).max())
            say("--serve --n_devices {} at stride {}: max|diff| {:.3e} "
                "against --no_mesh".format(ranks, s, err))
            if err > 1e-5 * max(1.0, float(np.abs(a).max())):
                bad.append("--serve stride {}".format(s))
        if len(served["--n_devices"]) != 2:
            bad.append("--serve answered {} of 2".format(
                len(served["--n_devices"])))
    finally:
        os.chdir(here)
    return bad


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--cpu", action="store_true",
                        help="gloo ranks on the CPU instead of one card "
                             "each over NCCL")
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.cpu:
        torch.set_num_threads(1)
    say = lambda text: print("[mesh_check] " + text, flush=True)
    if not args.cpu:
        from . import card_line
        say("{}; {} CUDA device(s)".format(card_line(),
                                           torch.cuda.device_count()))
    with tempfile.TemporaryDirectory() as tmp:
        cases = _cases(args.cpu, tmp)
        figures, bad = compare(args.ranks, "cpu" if args.cpu else "cuda",
                               False, *cases, queue_size=256, directory=tmp,
                               say=say)
        for r, counts in enumerate(figures["launches"]):
            say("rank {} launches {}".format(r, json.dumps(counts)))
            if not args.cpu and any(counts.get(k, 0) <= 0 for k in (
                    "selective_scan", "dir_conv_silu",
                    "inv_perm_weighted_sum", "fused_attention",
                    "selective_scan_backward", "dir_conv_silu_backward",
                    "inv_perm_weighted_sum_backward")):
                bad.append("K1-K7 not all launched on rank {}".format(r))
        bad += _cli(args.ranks, args.cpu, tmp, say)
    figures.pop("launches")
    print(json.dumps(dict(figures, ranks=args.ranks, failed=bad)),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
