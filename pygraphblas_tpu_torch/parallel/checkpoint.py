"""Checkpoint/resume + elastic restart for long-running distributed
iterations.

Design (the JAX package's ``parallel/checkpoint.py``, with the same
file format, so that a snapshot written by either package resumes in
the other):

- **atomic snapshots**: state is written to ``<path>.tmp`` then
  renamed, so a crash mid-write never corrupts the resume point;
- **run signatures**: a snapshot carries a caller-supplied signature
  (graph nnz/dims/hyperparameters); a resume with a mismatched
  signature is refused rather than silently diverging;
- **deterministic resume**: iteration state is host-side numpy, so a
  restart replays the remaining iterations from the snapshot's exact
  values;
- **elastic_run**: supervision loop that restarts a step function from
  the last snapshot after transient failures, up to a restart budget.

Under ``torch.distributed`` every rank runs the same program (SPMD):
only rank 0 writes a snapshot, and every rank reads one between two
barriers, so that no rank reads a file that rank 0 is still writing or
has already replaced with a later one.
"""

import os
import time

import numpy as np
import torch.distributed as dist

from ..base import burble


def _grouped():
    return dist.is_available() and dist.is_initialized()


def save_state(path, signature, step, **arrays):
    """Atomically snapshot iteration state (rank 0 writes; every rank
    waits at a barrier until the file is in place)."""
    if not _grouped() or dist.get_rank() == 0:
        tmp = str(path) + ".tmp"
        np.savez(tmp, __signature__=np.asarray(signature),
                 __step__=np.asarray(step), **arrays)
        os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
        burble("checkpoint: step %d -> %s", step, path)
    if _grouped():
        dist.barrier()


def load_state(path, signature):
    """Load a snapshot; returns (step, arrays) or None when absent or
    signature-mismatched.  Every rank reads between two barriers: after
    rank 0's last write, and before any rank's next one."""
    if _grouped():
        dist.barrier()
    try:
        return _read_state(path, signature)
    finally:
        if _grouped():
            dist.barrier()


def _read_state(path, signature):
    if not os.path.exists(path):
        return None
    try:
        data = np.load(path, allow_pickle=False)
    except Exception as e:  # noqa: BLE001 — unreadable means start fresh
        burble("checkpoint: unreadable %s (%s); starting fresh", path, e)
        return None
    if str(data["__signature__"]) != str(np.asarray(signature)):
        burble("checkpoint: signature mismatch; starting fresh")
        return None
    step = int(data["__step__"])
    arrays = {k: data[k] for k in data.files
              if not k.startswith("__")}
    burble("checkpoint: resuming from step %d", step)
    return step, arrays


def elastic_run(step_fn, init_state, n_steps, checkpoint_path=None,
                signature="", checkpoint_every=10, max_restarts=3):
    """Run ``state = step_fn(step, state)`` for n_steps with periodic
    snapshots and restart-on-failure.

    ``state`` is a dict of numpy arrays.  Returns the final state.
    Transient exceptions roll back to the last snapshot (or the initial
    state) and retry, up to ``max_restarts``.  Under
    ``torch.distributed`` every rank must fail or succeed together: the
    snapshots' barriers expect every rank."""
    state = {k: np.asarray(v) for k, v in init_state.items()}
    start = 0
    if checkpoint_path:
        resumed = load_state(checkpoint_path, signature)
        if resumed is not None:
            start, state = resumed
    restarts = 0
    step = start
    while step < n_steps:
        try:
            state = step_fn(step, state)
            step += 1
            if checkpoint_path and (step % checkpoint_every == 0
                                    or step == n_steps):
                save_state(checkpoint_path, signature, step, **state)
        except Exception as e:  # noqa: BLE001 — supervision boundary
            restarts += 1
            if restarts > max_restarts:
                raise
            burble("elastic_run: step %d failed (%s); restart %d/%d",
                   step, e, restarts, max_restarts)
            time.sleep(0.1 * restarts)
            if checkpoint_path:
                resumed = load_state(checkpoint_path, signature)
                if resumed is not None:
                    step, state = resumed
                    continue
            step, state = 0, {k: np.asarray(v)
                              for k, v in init_state.items()}
    return state
