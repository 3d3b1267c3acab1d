"""ctypes bindings of the native runtime pieces (PyTorch counterpart of
rebvo_tpu/io/native.py).

Two libraries, both built with g++ at first use into `build/native/` at
the repository root (the file name carries a hash of the source and the
flags, so an edited source rebuilds), never at import:

* the transport, `rebvo_tpu_torch/csrc/rebvo_transport.cpp`: CRC16, the
  pipeline ring, the fragmented-UDP port and the keyline quantizer. It
  is the port's own copy of those parts of `native/rebvo_native.cpp`
  and needs nothing but g++ and pthreads;
* the frame loader, `native/rebvo_native.cpp` itself (it decodes PNG
  with libpng), for `NativeFrameLoader` only. Where libpng's headers are
  missing the loader raises; the port's dataset path reads frames with
  its own `io/png` and does not need it.

`native_available()` says whether the transport loads, as in the JAX
package. `quantize_keylines` takes the port's KeylineMap (tensors on any
device) and moves the fields the wire format reads to the host in one
transfer (`frontend/state.keylines_to_host`).
"""

from __future__ import annotations

import ctypes as C
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from rebvo_tpu_torch.frontend.state import keylines_to_host

_ROOT = Path(__file__).resolve().parents[2]
TRANSPORT_SRC = _ROOT / "rebvo_tpu_torch" / "csrc" / "rebvo_transport.cpp"
NATIVE_SRC = _ROOT / "native" / "rebvo_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
# native/Makefile's flags
FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]

# KeylineMap fields the wire format reads, in the order of
# rn_quantize_keylines' arguments
_F32_FIELDS = ("x", "y", "gx", "gy", "n_m", "rho", "s_rho")
_I32_FIELDS = ("n_id", "m_num")
WIRE_FIELDS = _F32_FIELDS + _I32_FIELDS + ("valid",)


def _build(src: Path, name: str, libs) -> Path:
    """Compile `src` into build/native/<name>-<hash>.so unless it is
    there; raises RuntimeError with the compiler's output on failure."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        FLAGS + list(libs)).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the native library cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *FLAGS, str(src), "-o", str(tmp), *libs],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed on {src.name}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def _f32p():
    return np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _i32p():
    return np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _u8p():
    return np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _bind_transport(lib) -> None:
    lib.rn_crc16.restype = C.c_uint16
    lib.rn_crc16.argtypes = [C.c_char_p, C.c_int]

    lib.rn_pipeline_create.restype = C.c_void_p
    lib.rn_pipeline_create.argtypes = [C.c_int, C.c_int]
    lib.rn_pipeline_destroy.argtypes = [C.c_void_p]
    lib.rn_pipeline_request.restype = C.c_int
    lib.rn_pipeline_request.argtypes = [C.c_void_p, C.c_int, C.c_int]
    lib.rn_pipeline_release.argtypes = [C.c_void_p, C.c_int]

    lib.rn_udp_create.restype = C.c_void_p
    lib.rn_udp_create.argtypes = [C.c_char_p, C.c_int, C.c_int]
    lib.rn_udp_destroy.argtypes = [C.c_void_p]
    lib.rn_udp_send_fragmented.restype = C.c_int
    lib.rn_udp_send_fragmented.argtypes = [C.c_void_p, C.c_char_p, C.c_int]
    lib.rn_udp_recv_fragmented.restype = C.c_int
    lib.rn_udp_recv_fragmented.argtypes = [C.c_void_p, C.c_char_p, C.c_int,
                                           C.c_int]
    if hasattr(lib, "rn_udp_set_rcvbuf"):       # the port's copy only
        lib.rn_udp_set_rcvbuf.restype = C.c_int
        lib.rn_udp_set_rcvbuf.argtypes = [C.c_void_p, C.c_int]

    f32p, i32p, u8p = _f32p(), _i32p(), _u8p()
    lib.rn_net_keyline_size.restype = C.c_int
    lib.rn_quantize_keylines.restype = C.c_int
    lib.rn_quantize_keylines.argtypes = [
        f32p, f32p, f32p, f32p, f32p, f32p, f32p, i32p, i32p, u8p,
        C.c_int, C.c_float, u8p, i32p]
    lib.rn_dequantize_keylines.argtypes = [
        u8p, C.c_int, C.c_float, f32p, f32p, f32p, f32p, i32p, i32p,
        f32p, f32p]


_error: Optional[str] = None


@functools.cache
def load_native():
    """The transport library (built first if needed), or None when it
    cannot be built or loaded (the reason in `_error`)."""
    global _error
    try:
        lib = C.CDLL(str(_build(TRANSPORT_SRC, "librebvo_transport",
                                ["-lpthread"])))
    except (RuntimeError, OSError) as e:
        _error = str(e)
        return None
    _bind_transport(lib)
    return lib


def native_available() -> bool:
    return load_native() is not None


def _require():
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    return lib


@functools.cache
def _loader_lib():
    """native/rebvo_native.cpp built whole (with libpng) for the frame
    loader; raises where libpng's headers are missing."""
    try:
        path = _build(NATIVE_SRC, "librebvo_native", ["-lpng", "-lpthread"])
    except RuntimeError as e:
        raise RuntimeError(
            "NativeFrameLoader needs native/rebvo_native.cpp built with "
            "libpng, which failed here; read datasets with "
            "rebvo_tpu_torch.io.dataset (its own PNG decoder) instead.\n"
            f"{e}") from None
    lib = C.CDLL(str(path))
    _bind_transport(lib)
    f32p = _f32p()
    lib.rn_loader_open.restype = C.c_void_p
    lib.rn_loader_open.argtypes = [C.c_char_p, C.c_char_p, C.c_double,
                                   C.c_int, C.c_int, C.c_int]
    lib.rn_loader_count.restype = C.c_int
    lib.rn_loader_count.argtypes = [C.c_void_p]
    lib.rn_loader_next.restype = C.c_int
    lib.rn_loader_next.argtypes = [C.c_void_p, f32p, C.POINTER(C.c_double)]
    lib.rn_loader_close.argtypes = [C.c_void_p]
    return lib


# ---------------------------------------------------------------------------
# Pythonic wrappers
# ---------------------------------------------------------------------------


def crc16(data: bytes) -> int:
    return int(_require().rn_crc16(data, len(data)))


def net_keyline_size() -> int:
    """Byte size of one quantized keyline wire record."""
    return int(_require().rn_net_keyline_size())


# receive buffer a bound port asks for: a full-width packet (16384
# keylines and a raw 752x480 frame, ~620 KB) arrives as one burst
RCVBUF_BYTES = 16 << 20


class UdpPort:
    """Fragmented UDP transport (lossy telemetry semantics). A bound
    (receiving) port asks for an RCVBUF_BYTES receive buffer;
    `rcvbuf` is what the kernel granted (0 for a sending port)."""

    def __init__(self, host: str, port: int, bind: bool = False):
        self._lib = _require()
        self._h = self._lib.rn_udp_create(host.encode(), port, int(bind))
        if not self._h:
            raise OSError(f"udp_port create failed for {host}:{port}")
        self.rcvbuf = (self._lib.rn_udp_set_rcvbuf(self._h, RCVBUF_BYTES)
                       if bind else 0)

    def send(self, data: bytes) -> int:
        """Fragments sent, or -1 when the socket refused one."""
        return self._lib.rn_udp_send_fragmented(self._h, data, len(data))

    def recv(self, max_size: int = 1 << 22, timeout_ms: int = 1000
             ) -> Optional[bytes]:
        buf = C.create_string_buffer(max_size)
        n = self._lib.rn_udp_recv_fragmented(self._h, buf, max_size,
                                             timeout_ms)
        if n <= 0:
            return None
        return buf.raw[:n]

    def close(self):
        if self._h:
            self._lib.rn_udp_destroy(self._h)
            self._h = None


def quantize_keylines(klm, k_scale: float):
    """Quantize a KeylineMap (tensors on any device, moved to the host in
    one transfer; numpy views; or a `keylines_to_host` dict of
    WIRE_FIELDS) into the wire format. Returns (records bytes, count)."""
    lib = _require()
    h = klm if isinstance(klm, dict) else keylines_to_host(klm, WIRE_FIELDS)
    K = int(h["valid"].shape[0])
    rec_size = int(lib.rn_net_keyline_size())
    out = np.zeros(K * rec_size, np.uint8)
    id_map = np.zeros(K, np.int32)
    a32 = lambda v: np.ascontiguousarray(v, np.float32)
    i32 = lambda v: np.ascontiguousarray(v, np.int32)
    n = lib.rn_quantize_keylines(
        *[a32(h[f]) for f in _F32_FIELDS], *[i32(h[f]) for f in _I32_FIELDS],
        np.ascontiguousarray(h["valid"], np.uint8), K, float(k_scale), out,
        id_map)
    return out[:n * rec_size].tobytes(), n


def dequantize_keylines(data: bytes, k_scale: float) -> dict:
    lib = _require()
    rec_size = int(lib.rn_net_keyline_size())
    n = len(data) // rec_size
    buf = np.frombuffer(data, np.uint8).copy()
    f = {k: np.zeros(n, np.float32) for k in ("x", "y", "rho", "s_rho",
                                               "gx", "gy")}
    i = {k: np.zeros(n, np.int32) for k in ("n_id", "m_num")}
    lib.rn_dequantize_keylines(buf, n, float(k_scale), f["x"], f["y"],
                               f["rho"], f["s_rho"], i["n_id"], i["m_num"],
                               f["gx"], f["gy"])
    return dict(x=f["x"], y=f["y"], rho=f["rho"], s_rho=f["s_rho"],
                n_id=i["n_id"], m_num=i["m_num"], gx=f["gx"], gy=f["gy"])


class NativeFrameLoader:
    """Prefetching dataset loader (decode thread + pipeline ring) of
    native/rebvo_native.cpp; needs libpng to build (see the module
    note)."""

    def __init__(self, csv_path: str, img_dir: str, width: int, height: int,
                 time_scale: float = 1e-9, nbuf: int = 4):
        self._lib = _loader_lib()
        self._h = self._lib.rn_loader_open(
            csv_path.encode(), img_dir.encode(), time_scale, width, height,
            nbuf)
        if not self._h:
            raise OSError(f"loader open failed: {csv_path}")
        self.width = width
        self.height = height

    def __len__(self):
        return int(self._lib.rn_loader_count(self._h))

    def __iter__(self):
        out = np.zeros((self.height, self.width), np.float32)
        t = C.c_double()
        while True:
            r = self._lib.rn_loader_next(self._h, out, C.byref(t))
            if r == 0:
                break
            if r < 0:
                continue            # decode failure: skip frame
            yield float(t.value), out.copy()

    def close(self):
        if self._h:
            self._lib.rn_loader_close(self._h)
            self._h = None
