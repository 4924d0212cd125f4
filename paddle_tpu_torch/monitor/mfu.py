"""MFU accounting: chip peak table + achieved-FLOPs arithmetic.

A copy of the JAX package's paddle_tpu/monitor/mfu.py with the NVIDIA H100
rows added. This module owns the two inputs a throughput number needs to
become a utilization: a per-device-kind dense peak table (overridable via
FLAGS_monitor_chip_peak_tflops for chips the table doesn't know), and the
mfu() formula

    mfu = model_flops_per_step * steps_per_sec / chip_peak_flops

where model_flops_per_step comes from the compile probe
(monitor.compile_probe): the matmul and convolution FLOPs that
torch.utils.flop_counter counts over the first eager step of a prepared
program, 2 per multiply-add, the derived grads' forward recompute left out.
"""

from .. import flags

__all__ = ["CHIP_PEAK_TFLOPS", "chip_peak_flops", "mfu"]

flags.define(
    "monitor_chip_peak_tflops", float, 0.0,
    "Dense peak TFLOP/s of one chip for MFU accounting, overriding the "
    "built-in per-device-kind table (0 = use the table; unknown kinds "
    "report mfu=null rather than a made-up denominator).")

# Dense bf16 matmul peak per CHIP (all cores), TFLOP/s — published numbers.
# Keys are matched case-insensitively as substrings of the device kind
# (torch.cuda.get_device_name for a CUDA card), longest match wins
# ("TPU v5 lite" before "TPU v5"). The H100 rows are NVIDIA's data-sheet
# dense figures, not the 2x sparse ones: "NVIDIA H100 80GB HBM3" is the SXM
# part at its 700 W limit.
CHIP_PEAK_TFLOPS = {
    "TPU v2": 45.0,
    "TPU v3": 123.0,
    "TPU v4": 275.0,
    "TPU v5 lite": 197.0,   # v5e device_kind spelling
    "TPU v5e": 197.0,
    "TPU v5p": 459.0,
    "TPU v6 lite": 918.0,   # v6e (Trillium)
    "TPU v6e": 918.0,
    "H100 80GB HBM3": 989.4,
    "H100 PCIe": 756.5,
}


def _device_kind(device):
    """The kind string of `device`: its device_kind attribute (the JAX
    package's device objects), a CUDA card's name for a torch.device or a
    card index, None for the CPU or no card."""
    import torch

    kind = getattr(device, "device_kind", None)
    if kind is not None:
        return str(kind)
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = 0
    if isinstance(device, (str, torch.device)):
        device = torch.device(device)
        if device.type != "cuda":
            return None
    return torch.cuda.get_device_name(device)


def chip_peak_flops(device=None):
    """Peak FLOP/s of one chip, or None when unknown.

    Resolution order: FLAGS_monitor_chip_peak_tflops override, then the
    device-kind table. CPU / unknown accelerators return None — mfu() then
    reports null instead of a fictitious utilization. `device`: a
    torch.device, a card index, or an object with a device_kind; None is
    the first card."""
    override = flags.get("monitor_chip_peak_tflops")
    if override:
        return float(override) * 1e12
    kind = _device_kind(device) or ""
    best = None
    for name, tflops in CHIP_PEAK_TFLOPS.items():
        if name.lower() in kind.lower():
            if best is None or len(name) > len(best[0]):
                best = (name, tflops)
    return best[1] * 1e12 if best else None


def mfu(model_flops_per_step, steps_per_sec, peak_flops=None, device=None):
    """Model FLOPs utilization in [0, 1]; None when any input is unknown
    (no peak for this chip, no FLOPs captured)."""
    if peak_flops is None:
        peak_flops = chip_peak_flops(device)
    if not peak_flops or not model_flops_per_step or not steps_per_sec:
        return None
    return float(model_flops_per_step) * float(steps_per_sec) / \
        float(peak_flops)
