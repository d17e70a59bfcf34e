"""Persistent full-scene serving process.

Port of :mod:`vit_cnn_tpu.infer.server` with the same JSON-line protocol:
one JSON object per stdin line, one JSON response per stdout line. The
model stays on the device and scenes stay resident across requests.

Request fields (all optional):
  hsi / lidar  paths to scene arrays (.npy, or ``file.mat:key``); when
               omitted, the CLI's ``--dataset`` scene is served
  out          path to save the (H, W, n_classes) probability map (.npy)
  pred         path to save the argmax label map (.npy)
  gt           path to a ground-truth map; the response then carries
               OA/AA/Kappa (vit_cnn_tpu_torch.metrics)
  stride       test stride override (1: the row-band path; above 1: the
               per-origin path)
  cmd          "quit" ends the loop

Response: {"ok": true, "seconds": ..., "shape": [...], "uploads": n, ...}
or {"ok": false, "error": "..."}; ``uploads`` counts the scenes this
request put on the device (0: every scene was resident, a PCA model's
reduced HSI included).

Under a mesh (:mod:`..parallel.mesh`) every rank holds the model and
runs :meth:`SceneServer.loop`: rank 0 reads each request line and
broadcasts it (end of input as None), every rank maps its share of the
scene (infer/fullscene.py), and only rank 0 writes the ``out`` / ``pred``
files and answers. ``quit`` and the end of input end every rank.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, Optional, TextIO

import numpy as np
import torch

from ..data.io import load_mat_key, open_file
from ..metrics import metrics
from ..parallel.mesh import Mesh
from .fullscene import SceneCache, full_scene_probabilities

#: host scene arrays a server keeps (least recently used first out): one
#: request's HSI, LiDAR and ground truth, and one more
MAX_SCENES = 4


def _stamp(spec: str):
    """(mtime in ns, size) of the file behind ``spec``."""
    path = spec.rsplit(":", 1)[0] if ".mat:" in spec else spec
    st = os.stat(path)
    return st.st_mtime_ns, st.st_size


def load_array(spec: str) -> np.ndarray:
    """Load ``path.npy`` or ``path.mat:key``."""
    if ".mat:" in spec:
        path, key = spec.rsplit(":", 1)
        return np.asarray(load_mat_key(path, key))
    if spec.endswith(".mat"):
        raise ValueError(
            "'{}': .mat scenes need the variable name — use "
            "'file.mat:key'".format(spec))
    return np.asarray(open_file(spec))


class SceneServer:
    """Holds an eval-mode model and its hyperparameters and serves scenes.

    Host scene arrays loaded from paths are kept per path, so the
    device-resident scene cache hits on a repeated request: at most
    :data:`MAX_SCENES` of them, the least recently used dropped first
    (with their device copies), and a path whose file changed on disk
    (mtime or size) is loaded anew."""

    def __init__(self, model: torch.nn.Module, hyperparams: Dict,
                 ignored_labels=(), chunk: int = 8192,
                 mesh: Optional[Mesh] = None):
        self.model = model
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        self.hp = dict(hyperparams)
        self.ignored_labels = list(ignored_labels)
        self.chunk = chunk
        self.cache = SceneCache()
        # path -> (file stamp, host array), least recently used first
        self._scenes: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()

    def _scene(self, spec: Optional[str], default: np.ndarray):
        if not spec:
            return default
        stamp = _stamp(spec)
        held = self._scenes.get(spec)
        if held is not None and held[0] == stamp:
            self._scenes.move_to_end(spec)
            return held[1]
        if held is not None:
            self._drop(spec)
        arr = load_array(spec)
        self._scenes[spec] = (stamp, arr)
        while len(self._scenes) > MAX_SCENES:
            self._drop(next(iter(self._scenes)))
        return arr

    def _drop(self, spec: str) -> None:
        self.cache.drop(self._scenes.pop(spec)[1])

    def serve(self, img1: np.ndarray, img2: np.ndarray,
              stride: Optional[int] = None) -> np.ndarray:
        hp = self.hp
        if stride is not None:
            hp = dict(hp, test_stride=int(stride))
        return full_scene_probabilities(self.model, img1, img2, hp,
                                        chunk=self.chunk, cache=self.cache,
                                        mesh=self.mesh)

    def handle(self, req: Dict, default_img1: np.ndarray,
               default_img2: np.ndarray) -> Dict:
        t0 = time.time()
        uploads = self.cache.uploads
        img1 = self._scene(req.get("hsi"), default_img1)
        img2 = self._scene(req.get("lidar"), default_img2)
        probs = self.serve(img1, img2, req.get("stride"))
        resp: Dict = {"ok": True, "shape": list(probs.shape),
                      "uploads": self.cache.uploads - uploads}
        if self.rank != 0:
            return resp
        if req.get("out"):
            np.save(req["out"], probs)
            resp["out"] = req["out"]
        if req.get("pred") or req.get("gt"):
            pred = np.argmax(probs, axis=-1).astype(np.int32)
            if req.get("pred"):
                np.save(req["pred"], pred)
                resp["pred"] = req["pred"]
            if req.get("gt"):
                gt = self._scene(req["gt"], None)
                m = metrics(pred, gt, ignored_labels=self.ignored_labels,
                            n_classes=int(self.hp["n_classes"]))
                resp.update(OA=float(m["Accuracy"]), AA=float(m["AA"]),
                            Kappa=float(m["Kappa"]))
        resp["seconds"] = round(time.time() - t0, 3)
        return resp

    def _lines(self, in_stream: Optional[TextIO]):
        """The request lines: ``in_stream``'s, and under a mesh rank 0's
        broadcast to every rank (``in_stream`` is read on rank 0 only)."""
        if self.mesh is None:
            yield from in_stream
            return
        lines = iter(in_stream) if self.rank == 0 else None
        while True:
            line = next(lines, None) if self.rank == 0 else None
            line = self.mesh.broadcast_object(line)
            if line is None:
                return
            yield line

    def loop(self, in_stream: Optional[TextIO], out_stream: Optional[TextIO],
             default_img1: np.ndarray, default_img2: np.ndarray) -> int:
        """Read JSON-line requests until EOF / cmd=quit; returns count.
        Under a mesh, ``in_stream`` and ``out_stream`` are rank 0's (None
        on the others)."""
        served = 0
        say = (lambda resp: print(json.dumps(resp), file=out_stream,
                                  flush=True)) if self.rank == 0 else \
            (lambda resp: None)
        for line in self._lines(in_stream):
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except json.JSONDecodeError as e:
                say({"ok": False, "error": "bad json: {}".format(e)})
                continue
            if req.get("cmd") == "quit":
                break
            try:
                resp = self.handle(req, default_img1, default_img2)
                served += 1
            except Exception as e:               # keep the server alive
                resp = {"ok": False, "error": "{}: {}".format(
                    type(e).__name__, str(e)[:300])}
            say(resp)
        return served
