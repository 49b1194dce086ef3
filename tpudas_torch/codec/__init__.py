"""tpudas_torch.codec — the compressed tile codec.

The port's copy of :mod:`tpudas.codec`, byte for byte in its formats:
a blob either package encodes decodes in the other, and the same array,
codec and parameters encode to the same bytes.

- :mod:`tpudas_torch.codec.frame` — the versioned, self-describing
  ``.tpt`` tile container: a small canonical JSON header (codec id,
  dtype, shape, params, payload crc32, raw byte count), then the
  encoded payload.  The crc32 is embedded, so a compressed tile needs
  no ``.crc`` sidecar and a torn write shows from the file alone
  (:func:`verify_tile_blob` is what the integrity audit calls).
- :mod:`tpudas_torch.codec.codecs` — the codec registry: lossless
  ``deflate`` and ``bitshuffle-deflate`` (bit transposition before
  deflate), and the controlled-lossy ``quantize-deflate`` whose
  ``max_error`` is an absolute error bound, with NaN gaps carried
  exactly through a reserved integer sentinel.

Codec selection is a spec string (``"bitshuffle-deflate"``,
``"quantize-deflate:max_error=1e-3"``) accepted by the pyramid writer
(``sync_pyramid(codec=...)`` / ``TPUDAS_CODEC``) and by
``rebuild_pyramid`` for offline re-encodes.  Host code only: numpy and
zlib.
"""

from tpudas_torch.codec.codecs import (
    Codec,
    CodecError,
    codec_ids,
    get_codec,
    parse_codec_spec,
    register_codec,
)
from tpudas_torch.codec.frame import (
    MAGIC,
    TILE_BLOB_SUFFIX,
    decode_tile,
    encode_tile,
    read_tile_header,
    verify_tile_blob,
)

__all__ = [
    "Codec",
    "CodecError",
    "MAGIC",
    "TILE_BLOB_SUFFIX",
    "codec_ids",
    "decode_tile",
    "encode_tile",
    "get_codec",
    "parse_codec_spec",
    "read_tile_header",
    "register_codec",
    "verify_tile_blob",
]
