"""How far the flagship's float32 gradients move when only rounding does.

  python -m vit_cnn_tpu_torch.tools.train_conditioning

One float32 train step (32 centers of a 40 x 200 crop, flip off, seeded
weights) as ``chip_smoke.py``'s train-crop phase takes it, run on the card
twice and on the CPU with torch's default thread count and with one
thread. For each pair it prints the loss difference and, over the
gradients whose largest entry is at least 1e-4 of the model's largest,
the worst max|diff| / max|ref| and the worst ||diff|| / ||ref||, with the
parameters that reach them. The CPU against itself (only the summation
order changes) is the spread that any comparison of whole-step gradients
has to allow; ``chip_smoke.py`` sets its gradient limit from it. Run it
where a card is; without one it compares the CPU runs only.
"""

from __future__ import annotations

import json

import torch

from . import card_line, flagship_state, flagship_step, load_scene

BATCH = 32


def _step(scene, state, device):
    trainer, args = flagship_step(scene, state, device, BATCH)
    loss = float(trainer._step(*args))
    return loss, {k: p.grad.detach().double().cpu()
                  for k, p in trainer.model.named_parameters()}


def spread(got, ref):
    """(worst max|diff| / max|ref|, its key, worst ||diff|| / ||ref||,
    its key) over the gradients at least 1e-4 of the largest."""
    top = max(float(g.abs().max()) for g in ref[1].values())
    rows = [(float((got[1][k] - g).abs().max() / g.abs().max()),
             float((got[1][k] - g).norm() / g.norm()), k)
            for k, g in ref[1].items() if float(g.abs().max()) >= 1e-4 * top]
    by_max = max(rows)
    by_norm = max(rows, key=lambda r: r[1])
    return {"loss_diff": abs(got[0] - ref[0]),
            "max_rel": by_max[0], "max_rel_at": by_max[2],
            "norm_rel": by_norm[1], "norm_rel_at": by_norm[2],
            "gradients": len(rows)}


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.is_available()
    if card:
        print(card_line(), flush=True)
    scene = load_scene(crop=(40, 200))
    state = flagship_state(scene)
    threads = torch.get_num_threads()
    runs = {"cpu": _step(scene, state, "cpu")}
    if card:
        runs["card"] = _step(scene, state, "cuda")
        runs["card again"] = _step(scene, state, "cuda")
    torch.set_num_threads(1)
    runs["cpu 1 thread"] = _step(scene, state, "cpu")
    torch.set_num_threads(threads)
    pairs = [("cpu 1 thread", "cpu")]
    if card:
        pairs = [("card", "cpu"), ("card again", "card"),
                 ("card", "cpu 1 thread")] + pairs
    print(json.dumps({"cpu_threads": threads, "losses": {
        k: v[0] for k, v in runs.items()}}), flush=True)
    for a, b in pairs:
        print(json.dumps(dict(pair="{} vs {}".format(a, b),
                              **spread(runs[a], runs[b]))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
