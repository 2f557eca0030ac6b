"""Multi-host runtime bootstrap.

The reference is a single-process program; its closest analog is the CUDA
device selection at startup (demo.cpp:155-160). For multi-host runs, every
host process calls `init_distributed()` before touching any jax API that
enumerates devices; afterwards `jax.devices()` spans every host and the
meshes built by `dist.spmd.make_mesh` cover all devices, with collectives
chosen by XLA.

Typical launch (one process per host):
    DYNFU_COORDINATOR=host0:9876 DYNFU_NUM_PROCESSES=4 DYNFU_PROCESS_ID=$i \
        python -m dynfu_tpu.io.cli run <dataset>

On single-host (or when no coordinator is configured) this is a no-op, so
the same code path runs everywhere.
"""

from __future__ import annotations

import os
from typing import Optional


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed from args or DYNFU_* / JAX env vars.

    Returns True when a multi-process runtime was initialized, False for
    single-process operation. Idempotent.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get("DYNFU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("DYNFU_NUM_PROCESSES", "0") or 0)
    if process_id is None:
        process_id = int(os.environ.get("DYNFU_PROCESS_ID", "-1"))

    if not coordinator_address or num_processes <= 1:
        return False

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise
    return True


def is_primary() -> bool:
    """True on the process that should write artifacts/logs."""
    import jax

    return jax.process_index() == 0
