"""Runtime feature registry.

Capability parity with the reference's compiled-in feature list
(build_info.cc / is_feature_enabled, used for backend auto-pick
rtc_fwd.cc:514-515 and test skipping test_nesi.cc:677-684). Here features
are probed at runtime (import/device checks) instead of baked at build time.
"""

from __future__ import annotations

import importlib.util
from functools import lru_cache


@lru_cache(maxsize=None)
def is_feature_enabled(name: str) -> bool:
    if name in ("xla", "jax", "pallas"):
        return importlib.util.find_spec("jax") is not None
    if name == "gpu":
        import jax
        try:
            return bool(jax.devices("gpu"))
        except RuntimeError:  # no GPU backend in this process
            return False
    if name == "pil":
        return importlib.util.find_spec("PIL") is not None
    if name == "lmdb":
        # the pure-Python LMDB format layer (utils/lmdbmini.py) makes the
        # LMDB paths always available; the real module is used when present
        return True
    if name == "protobuf":
        return importlib.util.find_spec("google.protobuf") is not None
    if name == "zmq":
        return importlib.util.find_spec("zmq") is not None
    if name == "video":  # OpenCV VideoCapture/VideoWriter (ffmpeg role)
        return importlib.util.find_spec("cv2") is not None
    if name == "cpp":  # native C++ core library built and loadable
        from ..utils.cpplib import cpp_available
        return cpp_available()
    return False


def enabled_features() -> list[str]:
    return [f for f in ("xla", "gpu", "pallas", "pil", "lmdb", "protobuf",
                        "cpp", "zmq", "video")
            if is_feature_enabled(f)]
