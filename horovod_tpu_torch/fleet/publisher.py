"""Trainer-side weight publication, the port of
``horovod_tpu/fleet/publisher.py``.

A ``WeightPublisher`` rides the checkpoint plane's rank-0 post-commit hook
(``CheckpointManager(on_commit=...)``): every committed step becomes a
published weight generation by atomically renaming a publication pointer
(the step's global manifest, checksum set included, extended with a
monotonic ``generation`` id and the step directory's name) to
``<directory>/manifest.json``. Subscribers stat and read that one file;
because the hook runs before retention GC, the pointer always names a
directory that still exists.

Generation ids survive trainer preemption: a fresh publisher reads the
existing pointer and continues counting from it, so an exit-45 restart
publishes generation N+1, never a second N.
"""

import os

from ..utils import checkpoint as hvd_checkpoint
from ..utils import history as hvd_history
from ..utils import metrics as hvd_metrics


class WeightPublisher:
    """Publish committed checkpoints as monotonic weight generations.

    Attach with ``manager.on_commit = publisher.publish`` (or let
    ``trainer.Checkpointer(publish=True)`` wire it). Only the rank that
    commits manifests, rank 0, publishes; the hook already runs there.
    """

    def __init__(self, directory):
        self.directory = directory
        self._next_gen = 1
        latest = hvd_checkpoint.latest_manifest(directory)
        if latest is not None and latest[2].get("generation") is not None:
            self._next_gen = int(latest[2]["generation"]) + 1
        self._metrics = hvd_metrics.get_registry()
        self._m_pub = self._metrics.counter(
            "hvd_fleet_publishes_total",
            "Weight generations published by the trainer (one per "
            "committed checkpoint with publication enabled).")
        self._m_gen = self._metrics.gauge(
            "hvd_fleet_published_generation",
            "Newest weight generation the trainer has published.")

    @property
    def next_generation(self):
        """The id the next ``publish`` call will assign."""
        return self._next_gen

    def publish(self, step, step_dir, manifest):
        """Publish one committed step as the next generation; returns the
        generation id. The signature is the on_commit hook's."""
        gen = self._next_gen
        pointer = dict(manifest)
        pointer["generation"] = gen
        pointer["dir"] = os.path.basename(os.path.normpath(step_dir))
        hvd_checkpoint.write_pointer(self.directory, pointer)
        self._next_gen = gen + 1
        self._m_pub.inc()
        self._m_gen.set(gen)
        self._metrics.event(
            "fleet_publish", generation=gen, step=int(step),
            dir=pointer["dir"], files=len(manifest.get("files", {})))
        # anchor the durable run history at every published generation;
        # async, since the commit hook must not wait on its fsync
        hvd_history.flush(wait=False)
        return gen
