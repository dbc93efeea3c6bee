"""Synthetic SNDS-shaped data (numpy generators; tables on a device), the
columnar file format and the partitioned chunk store."""
from repro_torch.data.synthetic import (SyntheticConfig, generate_dcir,
                                        generate_pmsi, generate_snds)
from repro_torch.data.io import (
    save_columnar, save_columnar_arrays, load_columnar, load_columnar_arrays,
    save_star, load_star, csv_size_bytes, columnar_size_bytes,
)
from repro_torch.data.chunkstore import (
    ChunkManifest, ChunkMeta, ChunkStore, partition_star,
)

__all__ = ["SyntheticConfig", "generate_dcir", "generate_pmsi",
           "generate_snds", "save_columnar", "save_columnar_arrays",
           "load_columnar", "load_columnar_arrays", "save_star", "load_star",
           "csv_size_bytes", "columnar_size_bytes", "ChunkManifest",
           "ChunkMeta", "ChunkStore", "partition_star"]
