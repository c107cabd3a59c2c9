"""Shape-scatter results writer.

A NumPy copy of `nestinet_tpu/infer/writer.py::ShapeScatterWriter`
(importing the original pulls in JAX through `nestinet_tpu/infer/__init__.py`).
Streaming inference sees one flat stream of patches (all points of all
shapes, in order); the writer scatters per-batch outputs back into
per-shape buffers and writes `<shape>.normals`, `.experts` and
`.experts_probs` when a shape completes, byte-identical to np.savetxt
through the port's `core/textio.py`.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import textio


class ShapeScatterWriter:
    def __init__(self, output_dir: str, shape_names, shape_patch_counts,
                 n_experts: int | None = None):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.shape_names = list(shape_names)
        self.counts = list(shape_patch_counts)
        self.n_experts = n_experts
        self.shape_ind = 0
        self.offset = 0
        self.written: list[str] = []
        self._alloc()

    def _alloc(self):
        if self.shape_ind >= len(self.shape_names):
            return
        count = self.counts[self.shape_ind]
        self.normals = np.zeros((count, 3), dtype=np.float64)
        if self.n_experts is not None:
            self.experts = np.zeros((count,), dtype=np.int64)
            self.expert_probs = np.zeros((count, self.n_experts), dtype=np.float64)

    def append(self, normals, experts=None, expert_probs=None):
        """Append a batch of per-patch outputs (already trimmed of any
        padding rows)."""
        normals = np.asarray(normals)
        batch_offset = 0
        while batch_offset < normals.shape[0] and self.shape_ind < len(self.shape_names):
            remaining_shape = self.counts[self.shape_ind] - self.offset
            remaining_batch = normals.shape[0] - batch_offset
            take = min(remaining_shape, remaining_batch)

            dst = slice(self.offset, self.offset + take)
            src = slice(batch_offset, batch_offset + take)
            self.normals[dst] = normals[src]
            if self.n_experts is not None:
                self.experts[dst] = np.asarray(experts)[src]
                self.expert_probs[dst] = np.asarray(expert_probs)[src]

            self.offset += take
            batch_offset += take

            if self.offset == self.counts[self.shape_ind]:
                self._flush()

    def _flush(self):
        name = self.shape_names[self.shape_ind]
        textio.savetxt(os.path.join(self.output_dir, name + ".normals"), self.normals)
        if self.n_experts is not None:
            textio.savetxt(
                os.path.join(self.output_dir, name + ".experts"), self.experts,
                fmt="%i",
            )
            textio.savetxt(
                os.path.join(self.output_dir, name + ".experts_probs"),
                self.expert_probs,
            )
        self.written.append(name)
        self.shape_ind += 1
        self.offset = 0
        self._alloc()

    @property
    def done(self) -> bool:
        return self.shape_ind >= len(self.shape_names)
