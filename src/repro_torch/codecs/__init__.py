"""`repro_torch.codecs` — the codec API of the port.

    from repro_torch import codecs

    c = codecs.get("cusz", eb=1e-4, eb_mode="valrel").encode(x)
    y = codecs.decode(c)                  # the container is self-describing

Registered codecs:

    "cusz"        full dual-quant + canonical-Huffman pipeline (error-
                  bounded; kernel dispatch via `kernel_impl=`)
    "cusz-i"      multi-level cubic interpolation + canonical Huffman
                  (cuSZ-i; the same container surface as cusz)
    "fz"          Lorenzo + fused bit-plane shuffle with zero-plane
                  elision (FZ-GPU; the dict pipeline)
    "int8"        per-tensor symmetric int8 (eb = scale/2)
    "int16"       per-tensor symmetric int16
    "int8-block"  blockwise int8 along one axis (the KV-cache wire and
                  in-memory format)
    "zfp"         cuZFP-like fixed-rate block transform (baseline)
    "lossless"    identity (raw arrays; bitcast-safe for bf16 storage)

Every codec produces a versioned, self-describing `Container` (payload
dict + static header with codec id/version/dtype/shape/params);
`pack`/`unpack` switch between the device form and the host storage form,
and `to_arrays`/`from_arrays` bridge to npz-style field dicts.  Containers
are byte-compatible with the reference package's, in both directions.
"""
from .base import (Codec, decode, get, get_block_codec,  # noqa: F401
                   names, register)
from .container import (CONTAINER_FORMAT, ChecksumError,  # noqa: F401
                        Container, Header, check_container,
                        concat_containers, from_arrays, make_header,
                        payload_crc32, stamp_checksum, to_arrays,
                        verify_container)

# importing the implementation modules populates the registry
from . import cusz as cusz                # noqa: F401
from . import cusz_interp as cusz_interp  # noqa: F401
from . import fz as fz                    # noqa: F401
from . import int8 as int8                # noqa: F401
from . import lossless as lossless        # noqa: F401
from . import zfp as zfp                  # noqa: F401

__all__ = ["Codec", "Container", "Header", "CONTAINER_FORMAT",
           "ChecksumError", "check_container", "payload_crc32",
           "stamp_checksum", "verify_container", "decode", "get",
           "get_block_codec", "names", "register", "to_arrays",
           "from_arrays", "make_header", "concat_containers", "cusz",
           "cusz_interp", "fz", "int8", "lossless", "zfp"]
