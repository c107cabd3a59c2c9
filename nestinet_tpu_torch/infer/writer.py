"""Shape-scatter results writer.

A NumPy copy of `nestinet_tpu/infer/writer.py::ShapeScatterWriter`
(importing the original pulls in JAX through `nestinet_tpu/infer/__init__.py`).
Streaming inference sees one flat stream of patches (all points of all
shapes, in order); the writer scatters per-batch outputs back into
per-shape buffers and writes `<shape>.normals`, `.experts` and
`.experts_probs` when a shape completes, byte-identical to np.savetxt
through the port's `core/textio.py`.  With `gate_file` (the model's
`gate_files`), `.experts` holds the routes' ids and `<gate_file>` the
gate's `gate_rows` columns: the mixture of experts' probabilities in
`.experts_probs`, the routed switching model's noise estimate in `.noise`;
without it, `.normals` alone is written.
"""

from __future__ import annotations

import os

import numpy as np

from ..core import profiling, textio


class ShapeScatterWriter:
    def __init__(self, output_dir: str, shape_names, shape_patch_counts,
                 gate_file: str | None = None, gate_rows: int = 0):
        self.output_dir = output_dir
        self.gate_file = gate_file
        os.makedirs(output_dir, exist_ok=True)
        self.shape_names = list(shape_names)
        self.counts = list(shape_patch_counts)
        self.gate_rows = gate_rows
        self.shape_ind = 0
        self.offset = 0
        self.written: list[str] = []
        self._alloc()

    def _alloc(self):
        if self.shape_ind >= len(self.shape_names):
            return
        count = self.counts[self.shape_ind]
        self.normals = np.zeros((count, 3), dtype=np.float64)
        if self.gate_file is not None:
            self.experts = np.zeros((count,), dtype=np.int64)
            self.expert_probs = np.zeros((count, self.gate_rows), dtype=np.float64)

    def append(self, normals, experts=None, expert_probs=None):
        """Append a batch of per-patch outputs (already trimmed of any
        padding rows)."""
        with profiling.span("write"):
            normals = np.asarray(normals)
            batch_offset = 0
            while batch_offset < normals.shape[0] and self.shape_ind < len(self.shape_names):
                remaining_shape = self.counts[self.shape_ind] - self.offset
                remaining_batch = normals.shape[0] - batch_offset
                take = min(remaining_shape, remaining_batch)

                dst = slice(self.offset, self.offset + take)
                src = slice(batch_offset, batch_offset + take)
                self.normals[dst] = normals[src]
                if self.gate_file is not None:
                    self.experts[dst] = np.asarray(experts)[src]
                    self.expert_probs[dst] = np.asarray(expert_probs)[src]

                self.offset += take
                batch_offset += take

                if self.offset == self.counts[self.shape_ind]:
                    self._flush()

    def _flush(self):
        with profiling.span("write.flush"):
            name = self.shape_names[self.shape_ind]
            textio.savetxt(os.path.join(self.output_dir, name + ".normals"), self.normals)
            if self.gate_file is not None:
                textio.savetxt(
                    os.path.join(self.output_dir, name + ".experts"), self.experts,
                    fmt="%i",
                )
                textio.savetxt(
                    os.path.join(self.output_dir, f"{name}.{self.gate_file}"),
                    self.expert_probs,
                )
            self.written.append(name)
            self.shape_ind += 1
            self.offset = 0
            self._alloc()

    @property
    def done(self) -> bool:
        return self.shape_ind >= len(self.shape_names)
