"""Run-directory contract.

A copy of the serving part of `nestinet_tpu/core/rundir.py` (no
metrics log and no TensorBoard writer), so that the port imports nothing
of the JAX package.

Each training run owns a self-contained directory (parity with the
reference's contract, `train_n_est_w_experts.py:97-125, 354`):
    <log_dir>[/n]/
        description.txt   free-form run description
        config.json       full Config (replaces the py2 parameters.p pickle)
        gmm.json          the grid GMM (replaces gmm.p)
        ckpt/             checkpoints (params, state, opt_state, step)
        log_train.txt     textual training log
        <dataset>_results/  inference outputs (.normals/.experts/...)

Collision behavior matches the reference: an existing log_dir gets
auto-numbered subdirectories 1, 2, ...
"""

from __future__ import annotations

import os
import threading


class RunDir:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._log_file = None
        # the lock serializes log()'s lazy file open and appends
        self._io_lock = threading.Lock()

    # ---- creation ----
    @staticmethod
    def create(log_dir: str) -> "RunDir":
        """Create a fresh run dir, auto-numbering on collision."""
        if not os.path.exists(log_dir):
            return RunDir(log_dir)
        n = 0
        while True:
            n += 1
            candidate = os.path.join(log_dir, str(n))
            if not os.path.exists(candidate):
                return RunDir(candidate)

    @staticmethod
    def open(log_dir: str) -> "RunDir":
        if not os.path.isdir(log_dir):
            raise FileNotFoundError(f"run dir does not exist: {log_dir}")
        return RunDir(log_dir)

    # ---- paths ----
    @property
    def config_path(self) -> str:
        return os.path.join(self.path, "config.json")

    @property
    def gmm_path(self) -> str:
        return os.path.join(self.path, "gmm.json")

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.path, "ckpt")

    @property
    def ckpt_best_dir(self) -> str:
        """Best-validation-RMS checkpoint (written on val improvement;
        serving prefers it when present, resume always uses the LAST
        `ckpt/`).  The reference had neither best-tracking nor resume —
        it overwrote one model.ckpt every 10 epochs
        (`train_n_est_w_experts.py:247-250`)."""
        return os.path.join(self.path, "ckpt_best")

    def results_dir(self, dataset_name: str) -> str:
        d = os.path.join(self.path, f"{dataset_name}_results")
        os.makedirs(d, exist_ok=True)
        return d

    # ---- artifacts ----
    def write_description(self, desc: str) -> None:
        with open(os.path.join(self.path, "description.txt"), "w") as f:
            f.write(desc + "\n")

    def log(self, msg: str) -> None:
        """Append to log_train.txt and echo to stdout (thread-safe)."""
        with self._io_lock:
            if self._log_file is None:
                self._log_file = open(
                    os.path.join(self.path, "log_train.txt"), "a"
                )
            self._log_file.write(msg + "\n")
            self._log_file.flush()
        print(msg, flush=True)

    def close(self) -> None:
        if self._log_file is not None:
            self._log_file.close()
        self._log_file = None
