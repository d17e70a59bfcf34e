"""The generator of serving traffic (``kind`` "serve"): one client sending
whole-scene requests back to back to the port's ``SceneServer``.

Set-up makes the scene and the weights from the seed, builds the model
with the registry's ``get_model`` and ``load_state_dict``, puts the scene
on the card in the server's ``SceneCache`` (so every request is served
on the resident scene) and serves one band of the same shapes as a
warm-up. The window (:meth:`Serve.window`) starts at the first request
and closes when the first request that ends at or after ``seconds``
ends: no request is cut. A request is ``SceneServer.serve``: the band
loop of ``infer/fullscene.py`` over every window origin at the mix's
stride and chunk, ending with the (H, W, K) float32 map on the host.

``correct`` (:meth:`Serve.check`): once the window has closed and the
program's state is freed, a sample of (request, band) pairs drawn from
the seed is recomputed by the configuration's plain float32 reference
from the same host scene and weights, and every map's border (which no
window centre reaches) must be exactly zero.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from . import layout, scene as scene_lib, weights as weights_lib
from .precision import MODES


def windows(img: torch.Tensor, x0: int, rows: int, p: int) -> torch.Tensor:
    """(rows x Wc, P, P, C) windows of origin rows x0 .. x0 + rows - 1 of
    an (H, W, C) scene, by unfolding (Wc = W - P + 1)."""
    strip = img[x0:x0 + rows + p - 1]
    u = strip.unfold(0, p, 1).unfold(1, p, 1)             # (r, Wc, C, P, P)
    return u.permute(0, 1, 3, 4, 2).reshape(-1, p, p, img.shape[-1])


class Serve:
    #: the mix's keys that this generator reads
    KEYS = ("kind", "loop", "clients", "stride", "chunk", "precision",
            "trace_requests", "check_bands", "reference_block")
    #: the one way of sending that it implements
    FIXED = {"loop": "closed", "clients": 1}

    def __init__(self, info: Dict, seed: int, device, fault=None):
        self.cfg, self.mix = info["config"], info["traffic"]
        self.seed, self.device = int(seed), torch.device(device)
        self.fault = fault
        self.maps: List[np.ndarray] = []
        self.work: Dict = {}

    # ------------------------------------------------------------ set-up
    def prepare(self):
        """The scene, the model (parameters not filled) and the band
        geometry: everything but the program's state on the card."""
        from vit_cnn_tpu_torch.models.registry import get_model

        cfg, mix = self.cfg, self.mix
        p = int(cfg["patch_size"])
        self.scene = scene_lib.make(cfg["scene"], self.seed, self.device,
                                    margin=p // 2 + 1)
        img1, img2 = self.scene["img1"], self.scene["img2"]
        net, _, hp = get_model(
            cfg["model"], dataset="gpubench", n_classes=cfg["n_classes"],
            n_bands=(img1.shape[2], img2.shape[2]), ignored_labels=[0],
            bf16=mix["precision"] == "bfloat16",
            test_stride=int(mix["stride"]))
        self.shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        h, w = img1.shape[:2]
        self.total, self.wc = h - p + 1, w - p + 1
        self.rows = max(1, min(self.total, int(mix["chunk"]) // self.wc))
        self.bands = -(-self.total // self.rows)
        return net, hp

    def setup(self) -> None:
        from vit_cnn_tpu_torch.infer.server import SceneServer

        net, hp = self.prepare()
        mix, p = self.mix, int(self.cfg["patch_size"])
        img1, img2 = self.scene["img1"], self.scene["img2"]
        net.to(self.device)
        net.load_state_dict(weights_lib.seeded_state(self.shapes, self.seed,
                                                     self.device))
        net.eval()
        if self.fault is not None:
            net = self.fault(net)
        self.server = SceneServer(net, hp, ignored_labels=[0],
                                  chunk=int(mix["chunk"]))
        # one band of the window's shapes, then the scene made resident
        crop = [np.ascontiguousarray(a[:self.rows + p - 1])
                for a in (img1, img2)]
        self.server.serve(*crop)
        for a in crop:
            self.server.cache.drop(a)
        dtype = torch.bfloat16 if hp.get("bf16") else torch.float32
        dev = next(self.server.model.parameters()).device
        self.server.cache.get(img1, dtype, dev)
        self.server.cache.get(img2, dtype, dev)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ window
    def request(self) -> None:
        self.maps.append(self.server.serve(self.scene["img1"],
                                           self.scene["img2"]))

    def window(self, seconds: float, tracer=None) -> Dict:
        """Requests back to back until one ends at or after ``seconds``;
        with ``tracer`` the profiler starts with the first request and the
        next ``trace_requests`` run inside its traced span (the window
        goes on until they have)."""
        n_traced = int(self.mix["trace_requests"]) if tracer else 0
        t0 = time.perf_counter()
        if tracer:
            tracer.start()
        while True:
            if 1 <= len(self.maps) <= n_traced:
                with tracer.span():
                    self.request()
            else:
                self.request()
            if (time.perf_counter() - t0 >= seconds
                    and len(self.maps) > n_traced):
                break
        elapsed = time.perf_counter() - t0
        n = len(self.maps)
        per = self.total * self.wc
        band = self.rows * self.wc
        self.work = {"attempted": n, "windows": n * per,
                     "bands": n * self.bands, "seconds": elapsed,
                     "traced": {"requests": n_traced,
                                "windows": n_traced * per,
                                "bands": n_traced * self.bands,
                                "computed_windows":
                                    n_traced * self.bands * band}}
        return {"serve_windows_per_s": n * per / elapsed}

    def release(self) -> None:
        del self.server
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def sample(self, n: int) -> List[tuple]:
        """(request, band) pairs of ``n`` requests drawn from the seed:
        ``check_bands`` of them, the last request's last band always among
        them."""
        rng = np.random.default_rng(self.seed)
        pairs = [(n - 1, self.bands - 1)]
        k = min(int(self.mix["check_bands"]), n * self.bands) - 1
        others = [i for i in range(n * self.bands - 1)]
        for i in rng.choice(len(others), size=k, replace=False):
            pairs.append(divmod(int(others[i]), self.bands))
        return pairs

    def reference_logits(self, band: int, mode: str = "float32",
                         sd=None, scene=None) -> torch.Tensor:
        """The reference's float32 logits of one band's valid windows,
        row-major, in blocks of ``reference_block`` windows."""
        ref = layout.module("reference", self.cfg["name"])
        p = int(self.cfg["patch_size"])
        x0 = band * self.rows
        rows = min(self.rows, self.total - x0)
        w1 = windows(scene[0], x0, rows, p)
        w2 = windows(scene[1], x0, rows, p)
        blk = int(self.mix["reference_block"])
        out = [ref.forward(sd, w1[i:i + blk], w2[i:i + blk], MODES[mode])
               for i in range(0, len(w1), blk)]
        return torch.cat(out).float()

    def reference_inputs(self):
        sd = weights_lib.seeded_state(self.shapes, self.seed, self.device)
        scene = [torch.from_numpy(self.scene[k]).to(self.device)
                 for k in ("img1", "img2")]
        return sd, scene

    def served_logits(self, request: int, band: int) -> torch.Tensor:
        p = int(self.cfg["patch_size"])
        x0 = band * self.rows
        rows = min(self.rows, self.total - x0)
        block = self.maps[request][x0 + p // 2:x0 + p // 2 + rows,
                                   p // 2:p // 2 + self.wc]
        return torch.from_numpy(np.ascontiguousarray(block)).reshape(
            rows * self.wc, -1).to(self.device)

    def border_nonzero(self) -> List[int]:
        """Per map, the entries that no window centre reaches and that are
        not exactly 0."""
        c = int(self.cfg["patch_size"]) // 2
        out = []
        for m in self.maps:
            inner = np.zeros(m.shape[:2], dtype=bool)
            inner[c:c + self.total, c:c + self.wc] = True
            out.append(int(np.count_nonzero(m[~inner])))
        return out

    def gaps(self, mode: str = "program", requests: int = 0):
        """The widest and the RMS gap of the sampled logits to the float32
        reference's, over the reference's largest magnitude and RMS in
        the sample: the served maps' (``mode`` "program"), or the
        reference's own in ``mode`` ("fp8": the control) at the bands a
        run of ``requests`` requests would sample."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sd, scene = self.reference_inputs()
        num = den = diff_max = ref_max = 0.0
        for request, band in self.sample(requests or len(self.maps)):
            want = self.reference_logits(band, "float32", sd, scene)
            got = (self.served_logits(request, band) if mode == "program"
                   else self.reference_logits(band, mode, sd, scene))
            d = (got - want).double()
            num += float((d * d).sum())
            den += float((want.double() ** 2).sum())
            diff_max = max(diff_max, float(d.abs().max()))
            ref_max = max(ref_max, float(want.abs().max()))
        return {"max_gap": diff_max / max(ref_max, 1e-30),
                "rms_gap": (num / max(den, 1e-30)) ** 0.5}

    def check(self) -> Dict[str, float]:
        """The numbers that decide ``correct``: :meth:`gaps` of the served
        maps, the border entries that are not zero, and the entries of
        any map that are not finite."""
        out = self.gaps()
        nonfinite = [int(np.count_nonzero(~np.isfinite(m)))
                     for m in self.maps]
        border = self.border_nonzero()
        self.work["failed"] = sum(1 for a, b in zip(nonfinite, border)
                                  if a or b)
        out.update(border_nonzero=float(sum(border)),
                   nonfinite=float(sum(nonfinite)))
        return out
