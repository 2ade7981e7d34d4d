"""Persistence and out-of-core subsystem of the port: the versioned
on-disk index format (manifest, checksums, codecs), the chunked streaming
builders, shard plans, and the :class:`Hercules` store handle that owns an
index directory's whole lifecycle (create, append to the journal, query
with the journal merged, compact to a new generation). The out-of-core
backends that serve a ``SavedIndex`` live in ``core/engine.py``."""
from repro_torch.storage.build import (  # noqa: F401
    build_index_streaming, build_index_to_disk, stream_base_files,
)
from repro_torch.storage.codecs import (  # noqa: F401
    CODEC_CHOICES, Codec, get_codec, list_codecs, register_codec,
)
from repro_torch.storage.format import (  # noqa: F401
    FORMAT_NAME, FORMAT_VERSION, IndexFormatError, SavedIndex, load_index,
    open_index, read_manifest, save_index, verify_files,
)
from repro_torch.storage.partition import (  # noqa: F401
    BALANCE_WARN_RATIO, RECORDED_SHARD_COUNTS, ShardPlan, partition_plan,
    partition_section, shard_plan,
)
from repro_torch.storage.store import Hercules  # noqa: F401
