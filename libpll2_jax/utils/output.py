"""Debug printers + hardware probe (reference: libpll-2 src/output.c,
src/hardware.c).

The formatted printers define the reference's golden-file test format;
they are replicated byte-for-byte ("%+2.*f   " / "{(p,p,p,p),...}" forms,
scaling undone for display, output.c:26-101).  The hardware probe is the
JAX analog of cpuid detection (hardware.c:166-196): it reports the
JAX backend, device kind/count, and the mesh axes available for sharding.
"""
from __future__ import annotations

import io
from typing import Optional

import numpy as np


def format_pmatrix(pmatrix: np.ndarray, float_precision: int = 4) -> str:
    """pll_show_pmatrix (output.c:26-46): pmatrix [R, S, S]."""
    fp = io.StringIO()
    R, S, _ = pmatrix.shape
    for k in range(R):
        for i in range(S):
            for j in range(S):
                fp.write(f"%+2.{float_precision}f   "
                         % pmatrix[k, i, j])
            fp.write("\n")
        fp.write("\n")
    return fp.getvalue()


def format_clv(clv: np.ndarray, scaler: Optional[np.ndarray],
               sites: int, float_precision: int = 4,
               scale_threshold: float = 2.0 ** -256,
               site_id: Optional[np.ndarray] = None) -> str:
    """pll_show_clv (output.c:56-101): clv [R, S, T] engine layout;
    scaling is undone for display; repeats dereferenced via site_id."""
    fp = io.StringIO()
    R, S, _ = clv.shape
    fp.write("[ ")
    for s in range(sites):
        i = int(site_id[s]) if site_id is not None else s
        fp.write("{")
        for j in range(R):
            fp.write("(")
            vals = clv[j, :, i].astype(np.float64)
            if scaler is not None:
                vals = vals * scale_threshold ** int(
                    scaler[i] if np.ndim(scaler) == 1 else scaler[j, i])
            fp.write(",".join(f"%.{float_precision}f" % v for v in vals))
            fp.write(")")
            if j < R - 1:
                fp.write(",")
        fp.write("} ")
    fp.write("]\n")
    return fp.getvalue()


def show_pmatrix(partition, index: int, float_precision: int = 4) -> None:
    print(format_pmatrix(partition.get_pmatrix(index), float_precision),
          end="")


def show_clv(partition, clv_index: int, scaler_index: int,
             float_precision: int = 4) -> None:
    from ..constants import SCALE_BUFFER_NONE
    scaler = (None if scaler_index == SCALE_BUFFER_NONE
              else np.asarray(partition.scalers[scaler_index]))
    print(format_clv(np.asarray(partition.clv[clv_index]), scaler,
                     partition.cfg.sites, float_precision,
                     partition.cfg.scale_threshold,
                     site_id=partition.get_site_id(clv_index)),
          end="")


def hardware_probe() -> dict:
    """pll_hardware_probe analog (hardware.c:166-173): what compute
    is available and how it can be sharded."""
    import jax
    devs = jax.devices()
    return {
        "backend": jax.default_backend(),
        "device_count": jax.device_count(),
        "local_device_count": jax.local_device_count(),
        "device_kind": devs[0].device_kind if devs else None,
        "process_count": jax.process_count(),
        "x64_enabled": jax.config.read("jax_enable_x64"),
    }


def hardware_dump() -> None:
    """pll_hardware_dump analog (hardware.c:174-190)."""
    info = hardware_probe()
    print("JAX hardware probe:")
    for k, v in info.items():
        print(f"  {k}: {v}")
