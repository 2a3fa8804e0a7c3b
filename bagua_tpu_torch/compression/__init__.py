from .codecs import (  # noqa: F401
    CODECS,
    POLICY_VALUES,
    OneBitEfCodec,
    RingCodec,
    TopKCodec,
    get_codec,
    resolve_codec,
    validate_codec_policy,
)
from .minmax_uint8 import (  # noqa: F401
    compress_chunked,
    compressed_scatter_gather_allreduce,
    decompress_chunked,
)
