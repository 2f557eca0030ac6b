"""Device enumeration / info — analog of the reference's CUDA device
management (kfusion::cuda::getCudaEnabledDeviceCount / setDevice /
printCudaDeviceInfo, include/kfusion/kinfu.hpp:23-31, src/kfusion/core.cpp:
8-211). The pre-Fermi capability gate becomes a platform sanity check."""

from __future__ import annotations


def device_count() -> int:
    import jax

    return len(jax.devices())


def devices():
    import jax

    return jax.devices()


def print_short_device_info(index: int = 0) -> str:
    """One-line device summary (printShortCudaDeviceInfo analog)."""
    import jax

    d = jax.devices()[index]
    line = (
        f"Device {index}: {d.device_kind} (platform {d.platform}, "
        f"process {d.process_index}, {device_count()} device(s) visible)"
    )
    print(line)
    return line


def print_device_info(index: int = 0) -> str:
    """Multi-line device report (printCudaDeviceInfo analog, core.cpp:40+)."""
    import jax

    d = jax.devices()[index]
    lines = [
        f"Device {index}: {d.device_kind}",
        f"  platform:        {d.platform}",
        f"  process index:   {d.process_index}",
        f"  id:              {d.id}",
        f"  visible devices: {device_count()}",
    ]
    stats = getattr(d, "memory_stats", lambda: None)()
    if stats:
        for k in ("bytes_in_use", "bytes_limit"):
            if k in stats:
                lines.append(f"  {k}: {stats[k] / 2**20:.0f} MiB")
    out = "\n".join(lines)
    print(out)
    return out


def check_platform() -> bool:
    """True when a GPU backend is in use (the moral analog of the
    reference's checkIfPreFermiGPU check, core.cpp:31-38). Prints
    "no GPU" to stderr and returns False otherwise."""
    import sys

    import jax

    if jax.default_backend() != "gpu":
        print(f"no GPU: JAX backend is {jax.default_backend()!r}",
              file=sys.stderr)
        return False
    return True


def require_gpu() -> None:
    """Exit with status 2 unless JAX runs on a GPU: a measurement or a
    smoke run on another backend would report numbers for the wrong
    device."""
    if not check_platform():
        raise SystemExit(2)
