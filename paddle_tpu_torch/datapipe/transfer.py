"""Transfer engine: compressed wire formats for the host->device link.

Ship each feed across the link in a compact wire dtype (uint8 pixels, bf16
activations) and decode it on the card, inside the step: a uint8 image
batch moves a quarter of the bytes of its float32 form.

A WireSpec maps feed names to WireFormats. It rides the pipeline in two
places:

  encode side (host, AsyncDeviceFeeder): each batch is encoded into the
    chunk's pinned staging buffer in the wire dtype, so the copy to the
    card moves the compressed representation;
  decode side (device, Executor): the step is wrapped (`wrap_step`) so
    feed `x` becomes `x.to(compute_dtype) * scale + shift` before the
    first op reads it — per step, on the step's [batch, ...] slice, so the
    decompressed tensor never exists at [K, ...] chunk size, and inside
    the captured CUDA graph when the step is captured.

Staged chunk dicts carry the spec under WIRE_KEY (and reusable chunks a
DONATE_KEY lease); Executor.run pops both via pop_markers and extends its
prepared-step key with the spec fingerprint. The JAX package's
transfer.py is the reference: the encode is its numpy code (bfloat16 made
by torch's round-to-nearest-even, numpy having no such dtype), the decode
its jnp expression in torch ops, in its order.
"""

import functools

import numpy as np
import torch

from ..flags import define, get as get_flag

__all__ = ["WireFormat", "WireSpec", "WIRE_KEY", "DONATE_KEY",
           "pop_markers", "auto_wire"]

WIRE_KEY = "__wire__"      # staged-chunk metadata: the chunk's WireSpec
# staged-chunk metadata: the chunk's device buffers return to the feeder's
# ring once the consumer is done with them (feeder.ChunkLease)
DONATE_KEY = "__donate__"

define("wire_compress", bool, True,
       "Ship compressed wire formats on the host->device link by default "
       "(uint8 image feeds stay uint8 on the wire; the step on the card "
       "casts and normalizes them). FLAGS_wire_compress=0 reverts to "
       "uncompressed float feeds everywhere a pipe or bench path asked "
       "for the default.")


# numpy has no bfloat16: a bf16 wire array is held as uint16 carrying the
# bf16 bits, and staged into a torch.bfloat16 buffer
_BF16_CARRIER = np.dtype(np.uint16)


def _dtype_name(name):
    """Canonical name of a wire dtype given as a name or numpy dtype."""
    if str(name) in ("bfloat16", "bf16"):
        return "bfloat16"
    return str(np.dtype(name))


def _np_dtype(name):
    """The numpy dtype that holds a wire dtype on the host: itself, or
    uint16 for bfloat16."""
    name = _dtype_name(name)
    return _BF16_CARRIER if name == "bfloat16" else np.dtype(name)


def torch_dtype(name):
    """The torch dtype of a wire dtype name."""
    name = _dtype_name(name)
    return torch.bfloat16 if name == "bfloat16" \
        else torch.from_numpy(np.zeros(0, name)).dtype


def _to_bf16_bits(arr):
    """float array -> uint16 bfloat16 bits, rounded to nearest even (the
    rounding ml_dtypes' astype does)."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


class WireFormat:
    """How ONE feed travels the link.

    wire_dtype:    dtype on the wire (what the copy to the card moves)
    compute_dtype: dtype the step decodes to (None = the program
                   variable's declared dtype, resolved at wrap time)
    scale, shift:  fused on-device affine decode
                       decoded = cast(x, compute_dtype) * scale + shift
                   (and the host encode applies the exact inverse when it
                   must quantize a float source down to an integer wire)
    """

    __slots__ = ("wire_dtype", "compute_dtype", "scale", "shift")

    def __init__(self, wire_dtype, compute_dtype=None, scale=None,
                 shift=None):
        self.wire_dtype = _dtype_name(wire_dtype)
        self.compute_dtype = (None if compute_dtype is None
                              else _dtype_name(compute_dtype))
        self.scale = None if scale is None else float(scale)
        self.shift = None if shift is None else float(shift)

    def fingerprint(self):
        return (self.wire_dtype, self.compute_dtype, self.scale, self.shift)

    def __repr__(self):
        parts = [self.wire_dtype]
        if self.compute_dtype:
            parts.append(f"->{self.compute_dtype}")
        if self.scale is not None:
            parts.append(f"*{self.scale:g}")
        if self.shift is not None:
            parts.append(f"+{self.shift:g}")
        return f"WireFormat({' '.join(parts)})"

    # -- host side -------------------------------------------------------
    def encode(self, arr):
        """Host array -> wire array. A source already in the wire dtype
        passes through untouched (the common case: uint8 pixels straight
        from the decoder); a float source quantizing down to an integer
        wire applies the inverse of the on-device affine decode. A
        bfloat16 wire array comes back as its uint16 bits."""
        arr = np.asarray(arr)
        if str(arr.dtype) == self.wire_dtype:
            return arr
        if self.wire_dtype == "bfloat16":
            if arr.dtype == _BF16_CARRIER:
                return arr
            return _to_bf16_bits(arr)
        wd = _np_dtype(self.wire_dtype)
        if np.issubdtype(wd, np.integer) and \
                arr.dtype.kind in ("f", "V"):  # V: bf16 views land as void
            x = arr.astype(np.float32)
            if self.shift is not None:
                x = x - self.shift
            if self.scale is not None:
                x = x / self.scale
            info = np.iinfo(wd)
            return np.clip(np.rint(x), info.min, info.max).astype(wd)
        return arr.astype(wd)

    # -- device side (inside the step) -----------------------------------
    def decode(self, x, var_dtype=None):
        """Wire tensor -> compute tensor, in the JAX package's order: cast
        to the target dtype, then `* scale`, then `+ shift`, each constant
        a tensor of the target dtype. A uint16 tensor on a bfloat16 wire
        (bits staged as numpy) is read as bfloat16 first. It launches
        only device work, so it runs inside a captured step."""
        target = torch_dtype(self.compute_dtype or var_dtype or "float32")
        if self.wire_dtype == "bfloat16" and x.dtype != torch.bfloat16 \
                and x.dtype in (torch.int16, torch.uint16):
            x = x.view(torch.bfloat16)
        y = x.to(target) if x.dtype != target else x
        # the constants are made on the device (a fill, which a capture
        # records), never copied from the host
        if self.scale is not None:
            y = y * torch.full((), self.scale, dtype=target, device=y.device)
        if self.shift is not None:
            y = y + torch.full((), self.shift, dtype=target, device=y.device)
        return y


class WireSpec:
    """{feed_name: WireFormat} for one pipe. Immutable once built; hashable
    via fingerprint() so executors can key their prepared steps on it."""

    def __init__(self, formats):
        self._formats = {}
        for name, fmt in dict(formats).items():
            if not isinstance(fmt, WireFormat):
                fmt = WireFormat(fmt)
            self._formats[str(name)] = fmt

    # -- common cases ----------------------------------------------------
    @classmethod
    def uint8_images(cls, *names, scale=1.0 / 255.0, shift=None,
                     compute_dtype="float32"):
        """Pixels ride as uint8 (4x fewer link bytes than float32) and the
        step casts + normalizes: x/255 by default."""
        return cls({n: WireFormat("uint8", compute_dtype=compute_dtype,
                                  scale=scale, shift=shift) for n in names})

    @classmethod
    def bfloat16(cls, *names):
        """Float features ride as bf16 (2x fewer link bytes); decode is a
        plain widen to the variable's declared dtype."""
        return cls({n: WireFormat("bfloat16") for n in names})

    # -- mapping surface -------------------------------------------------
    def __contains__(self, name):
        return name in self._formats

    def __getitem__(self, name):
        return self._formats[name]

    def __iter__(self):
        return iter(self._formats)

    def __len__(self):
        return len(self._formats)

    def items(self):
        return self._formats.items()

    def fingerprint(self):
        return tuple(sorted(
            (n, f.fingerprint()) for n, f in self._formats.items()))

    def describe(self):
        """{feed_name: wire-format repr} — the journal-friendly rendering
        of what each covered feed looks like on the wire."""
        return {n: repr(f) for n, f in sorted(self._formats.items())}

    def __repr__(self):
        return f"WireSpec({self._formats!r})"

    # -- pipeline hooks --------------------------------------------------
    def wire_dtype(self, name, sample):
        """Host staging dtype for one feed (the wire dtype when covered,
        uint16 for a bfloat16 wire; the sample's own dtype otherwise)."""
        if name in self._formats:
            return _np_dtype(self._formats[name].wire_dtype)
        return np.asarray(sample).dtype

    def encode_feed(self, feed):
        """Encode every covered entry of a host feed dict (non-covered and
        '__'-metadata entries pass through)."""
        return {n: (self._formats[n].encode(v)
                    if n in self._formats and not n.startswith("__") else v)
                for n, v in feed.items()}

    def wrap_step(self, step, var_dtypes=None):
        """A step of executor_core.build_step_fn's signature (step(mut,
        const, feeds, rng, **kw) -> (fetches, new_mut)) with the covered
        feeds decoded first. It wraps the PER-STEP function, so the decode
        runs on each step's [batch, ...] slice, and in the captured graph
        when the step is captured. The wrapped step's attributes (ops,
        blocker, caps) stay readable on the wrapper."""
        var_dtypes = var_dtypes or {}

        @functools.wraps(step)
        def wired(mut_state, const_state, feeds, rng, **kw):
            feeds = dict(feeds)
            for n, fmt in self._formats.items():
                if n in feeds:
                    feeds[n] = fmt.decode(feeds[n], var_dtypes.get(n))
            return step(mut_state, const_state, feeds, rng, **kw)

        return wired


def auto_wire(sample):
    """Default WireSpec for a sample dict (`wire="auto"`): every uint8
    feed rides the link as uint8 and the step casts it to the
    program variable's declared dtype — numerically identical to the host
    cast it replaces, at a quarter of the link bytes when the variable is
    float32. Non-uint8 feeds are left alone (quantizing floats would
    change numerics, which is an explicit opt-in via WireSpec). Returns
    None when nothing qualifies or FLAGS_wire_compress=0."""
    if not get_flag("wire_compress") or not isinstance(sample, dict):
        return None
    names = []
    for n, v in sample.items():
        if n.startswith("__"):
            continue
        try:
            a = np.asarray(v)
        except Exception:
            continue
        if a.dtype == np.uint8:
            names.append(n)
    if not names:
        return None
    # pass-through wire + cast-only decode (no affine): the program's
    # declared var dtype resolves at wrap time
    return WireSpec({n: WireFormat("uint8") for n in names})


def pop_markers(feed):
    """Split transfer-engine metadata off a feed dict.

    Returns (feed, wire_spec, lease): `lease` is the chunk's
    feeder.ChunkLease, whose release(stream) the consumer calls once its
    work reading the chunk is enqueued on `stream`, or None. The input
    dict is left untouched — a shallow copy is made when markers are
    present (stage_fn chunks may be caller-owned and reused)."""
    if not isinstance(feed, dict) or \
            (WIRE_KEY not in feed and DONATE_KEY not in feed):
        return feed, None, None
    feed = dict(feed)
    wire = feed.pop(WIRE_KEY, None)
    lease = feed.pop(DONATE_KEY, None)
    return feed, wire, lease
