"""Native (C++) host components of the port, loaded with ctypes.

The fast CSV chain writer and reader (``fastcsv.cpp``) behind
:mod:`gpx_torch.io`, built with g++ at first use (:mod:`.build`). It is a
host component, not a device kernel: :mod:`gpx_torch.io` keeps a
pure-Python path that writes the same bytes.
"""

from gpx_torch.native.build import load_fastcsv

__all__ = ["load_fastcsv"]
