"""Multi-host serving: the fleet across the process boundary (counterpart
of ``singa_tpu/serve/dist``).

* :mod:`~singa_tpu_torch.serve.dist.transport` — framed socket transport
  (length-prefixed, versioned, crc-checked; typed timeout/retry;
  piggybacked heartbeats);
* :mod:`~singa_tpu_torch.serve.dist.worker` — the replica worker loop: one
  supervised engine behind the RPC dispatch, built from a picklable
  :class:`ModelSpec`;
* :mod:`~singa_tpu_torch.serve.dist.fleet` — :class:`DistFleet`, a
  :class:`~singa_tpu_torch.serve.fleet.ServeFleet` whose replicas are worker
  processes (or threads), with wire KV shipping — bulk images and
  layer-wise streamed frames — and the cross-host residency directory.

Controller survivability: a dropped socket enters a bounded
reconnect-with-resume window instead of condemning the peer (the
worker redials, the session resumes, the one unacked CALL replays
exactly-once); workers journal per-request progress and PARK finished
results when the controller vanishes; ``DistFleet.adopt`` attaches a
successor controller to the live workers under a bumped fencing epoch
— the dead controller's frames are refused typed
(:class:`StaleEpochError`), parked results re-deliver exactly once,
and routing resumes with the workers' captured decode steps intact.
"""

from .fleet import DistFleet, DistSession, RemoteSupervisor
from .transport import (IDEMPOTENT_OPS, PROTO_VERSION, Conn, Listener,
                        NonIdempotentReplayError, PeerGoneError,
                        PeerTimeoutError, StaleEpochError,
                        TransportError, resume_worker)
from .worker import ModelSpec, gpt2_spec, worker_main

__all__ = [
    "DistFleet", "DistSession", "RemoteSupervisor",
    "ModelSpec", "gpt2_spec", "worker_main",
    "PROTO_VERSION", "IDEMPOTENT_OPS", "Conn", "Listener",
    "PeerGoneError", "PeerTimeoutError", "TransportError",
    "StaleEpochError", "NonIdempotentReplayError", "resume_worker",
]
