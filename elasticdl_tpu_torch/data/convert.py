"""Convert any data source into EDLR recordio shards.

Role parity: the reference ships `scripts` that convert MNIST/CIFAR datasets
into RecordIO shards for its model zoo. `convert_to_recordio` turns any
AbstractDataReader (including the synthetic generators) into .rio shard
files, so benches and jobs exercise the real native read path.
"""

from __future__ import annotations

import os
from typing import List

from elasticdl_tpu_torch.common.log_utils import default_logger
from elasticdl_tpu_torch.data.reader import AbstractDataReader, create_data_reader
from elasticdl_tpu_torch.data.recordio import RecordIOWriter

logger = default_logger(__name__)


def convert_to_recordio(
    reader: AbstractDataReader,
    out_dir: str,
    records_per_shard: int = 50_000,
    chunk_bytes: int = 1 << 20,
) -> List[str]:
    """Write every record of `reader` into .rio shards under out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    files: List[str] = []
    writer = None
    count_in_shard = 0
    total = 0

    def new_writer() -> RecordIOWriter:
        path = os.path.join(out_dir, f"part-{len(files):05d}.rio")
        files.append(path)
        return RecordIOWriter(path, chunk_bytes=chunk_bytes)

    for shard_name, start, end in reader.create_shards():
        for record in reader.read_records(shard_name, start, end):
            if writer is None:
                writer = new_writer()
            writer.write(record)
            count_in_shard += 1
            total += 1
            if count_in_shard >= records_per_shard:
                writer.close()
                writer = None
                count_in_shard = 0
    if writer is not None:
        writer.close()
    logger.info("wrote %d records into %d shards under %s", total, len(files), out_dir)
    return files


def convert_url(
    source: str, out_dir: str, records_per_shard: int = 50_000
) -> List[str]:
    """Convenience: convert a reader URL/path (e.g. synthetic://criteo?n=1e6)."""
    return convert_to_recordio(
        create_data_reader(source), out_dir, records_per_shard
    )
