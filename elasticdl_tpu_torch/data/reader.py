"""Data readers: shard discovery + record reading for the task queue.

Reference parity: elasticdl/python/common/data_reader.py —
`AbstractDataReader.create_shards()` lists (shard_name, start, end) spans the
master turns into tasks, and `read_records(task)` yields the records of one
task on the worker. Implementations: RecordIO (native), ODPS table, CSV.

Rebuilt: TextLine (CSV/TSV), RecordIO (C++ reader in data/native once built,
with a pure-Python twin of the same format), and Synthetic readers that
deterministically generate MNIST/CIFAR/Criteo/census-shaped records so every
parity config trains self-contained (this sandbox has no dataset downloads;
the reference assumed data already in storage).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

Shard = Tuple[str, int, int]


def resolve_files(
    path: str,
    exclude_suffix: str = "",
    require_suffix: str = "",
) -> List[str]:
    """Glob / file / directory → sorted file list (shared by the file-backed
    readers). `require_suffix` filters dir/glob listings to one extension
    (fixed-width readers must not reinterpret stray files as records);
    `exclude_suffix` drops sidecar files (.edlidx.npy indexes)."""
    if any(c in path for c in "*?["):
        files = glob.glob(path)
    elif os.path.isfile(path):
        return [path]   # an explicit single path is always taken verbatim
    elif os.path.isdir(path):
        files = [os.path.join(path, f) for f in os.listdir(path)]
    else:
        return []
    if require_suffix:
        files = [f for f in files if f.endswith(require_suffix)]
    if exclude_suffix:
        files = [f for f in files if not f.endswith(exclude_suffix)]
    return sorted(files)


class AbstractDataReader:
    def create_shards(self) -> List[Shard]:
        """List (shard_name, start_record, end_record) spans."""
        raise NotImplementedError

    def read_records(self, shard_name: str, start: int, end: int) -> Iterator[bytes]:
        """Yield records [start, end) of one shard."""
        raise NotImplementedError

    def read_span(self, shard_name: str, start: int, end: int) -> List[bytes]:
        """Materialize records [start, end) as a list — the batch-pipeline
        entry point (TaskDataService reads batch-sized spans). File-backed
        readers override this with one contiguous read + vectorized split;
        the default just drains the per-record generator."""
        return list(self.read_records(shard_name, start, end))

    def read_block(self, shard_name: str, start: int, end: int) -> Optional[bytes]:
        """Records [start, end) as ONE contiguous byte blob, or None when the
        format can't provide it. Only fixed-width formats support this; it
        lets blob-accepting batch parsers (parsing.py `accepts_blob`) skip
        record splitting entirely."""
        return None

    # Readers whose read_span/read_block may be called from MULTIPLE threads
    # concurrently set this True (TaskDataService's parse pool checks it;
    # readers sharing per-shard handles/caches, like RecordIO, stay serial).
    THREAD_SAFE_SPANS = False

    @property
    def metadata(self) -> Dict:
        return {}


class TextLineDataReader(AbstractDataReader):
    """Newline-delimited files (CSV/TSV). Shard = file; record = line.

    Line offsets are indexed once per file on first read so seeks are O(1)
    afterwards (the role RecordIO's chunk index plays for binary records).
    """

    INDEX_SUFFIX = ".edlidx.npy"
    # read_span opens its own handle per call and _index is lock-guarded, so
    # the parse pool may fan spans of one shard across threads
    THREAD_SAFE_SPANS = True

    def __init__(self, path: str, skip_header: bool = False,
                 index_cache: bool = True, **_):
        import threading

        # exclude .edlidx.npy sidecars in dir AND glob listings: a pattern
        # like 'part-*' matches the sidecars a previous run wrote
        self._files = resolve_files(path, exclude_suffix=self.INDEX_SUFFIX)
        if not self._files:
            raise FileNotFoundError(f"no input files match {path!r}")
        self._skip_header = skip_header
        self._index_cache = index_cache
        self._offsets: Dict[str, np.ndarray] = {}
        # one thread builds a file's index; others wait instead of racing
        # duplicate scans + colliding on the sidecar tmp path
        self._index_lock = threading.Lock()

    SCAN_WINDOW = 64 << 20  # 64 MB

    def _scan_index(self, fname: str) -> np.ndarray:
        """All line-start offsets + EOF, found with vectorized newline scans
        over fixed-size windows (C speed, O(window) memory — a whole-file
        bool mask would transiently cost one byte per data byte, fatal on
        Criteo-sized TSVs)."""
        size = os.path.getsize(fname)
        if size == 0:
            return np.zeros(1, np.int64)
        parts = []
        # the index lock EXISTS to serialize this once-per-file scan
        # (concurrent readers must pay one scan, not one each):
        # edl-lint: disable=EDL103
        with open(fname, "rb") as f:
            pos = 0
            while True:
                chunk = f.read(self.SCAN_WINDOW)
                if not chunk:
                    break
                nl = np.flatnonzero(np.frombuffer(chunk, np.uint8) == 0x0A)
                if nl.size:
                    parts.append(nl.astype(np.int64) + pos)
                pos += len(chunk)
        nl = np.concatenate(parts) if parts else np.empty(0, np.int64)
        starts = np.concatenate([[0], nl + 1])
        if starts[-1] != size:  # last line has no trailing newline
            starts = np.concatenate([starts, [size]])
        return starts

    def _index(self, fname: str) -> np.ndarray:
        """Line-offset index, persisted to a sidecar `.edlidx.npy` so each
        file is scanned once per cluster, not once per process per run (the
        role RecordIO's footer index plays for binary shards). The sidecar is
        ignored when older than the data file; writing it is best-effort
        (read-only input dirs just re-scan)."""
        if fname in self._offsets:
            return self._offsets[fname]
        with self._index_lock:
            if fname in self._offsets:   # built while we waited
                return self._offsets[fname]
            idx_path = fname + self.INDEX_SUFFIX
            offs = None
            if self._index_cache and os.path.exists(idx_path):
                try:
                    if os.path.getmtime(idx_path) >= os.path.getmtime(fname):
                        cand = np.load(idx_path)
                        if cand.ndim == 1 and cand.size >= 1 and (
                            int(cand[-1]) == os.path.getsize(fname)
                        ):
                            offs = cand.astype(np.int64)
                except (OSError, ValueError):
                    offs = None
            if offs is None:
                offs = self._scan_index(fname)
                if self._index_cache:
                    # the temp name ENDS in the sidecar suffix (a crashed
                    # writer's orphan, or a mid-write listing, is excluded
                    # from data-file resolution like the final sidecar) and
                    # carries pid+thread id: same-file writers in OTHER
                    # processes must not collide either
                    import threading

                    tmp = (
                        f"{idx_path}.{os.getpid()}-{threading.get_ident()}"
                        f".tmp{self.INDEX_SUFFIX}"
                    )
                    try:
                        # sidecar persist rides the same once-per-file
                        # index window: edl-lint: disable=EDL103
                        with open(tmp, "wb") as f:
                            np.save(f, offs)
                        os.replace(tmp, idx_path)
                    except OSError:
                        pass
                    finally:
                        if os.path.exists(tmp):
                            try:
                                os.remove(tmp)
                            except OSError:
                                pass
            start = 1 if self._skip_header else 0
            self._offsets[fname] = offs[start:]
            return self._offsets[fname]

    def create_shards(self) -> List[Shard]:
        return [
            (f, 0, len(self._index(f)) - 1)
            for f in self._files
        ]

    def read_span(self, shard_name: str, start: int, end: int) -> List[bytes]:
        offs = self._index(shard_name)
        end = min(end, len(offs) - 1)
        if start >= end:
            return []
        with open(shard_name, "rb") as f:
            f.seek(offs[start])
            blob = f.read(int(offs[end] - offs[start]))
        base = int(offs[start])
        return [
            blob[int(offs[i]) - base: int(offs[i + 1]) - base].rstrip(b"\r\n")
            for i in range(start, end)
        ]

    def read_records(self, shard_name: str, start: int, end: int) -> Iterator[bytes]:
        """Streaming per-record path: O(1) memory regardless of span size —
        callers like data/convert.py iterate WHOLE-FILE shards here, where
        read_span's one-blob materialization would hold the file (+ a line
        list) in memory. The batch pipeline uses read_span on batch-sized
        spans instead."""
        offs = self._index(shard_name)
        end = min(end, len(offs) - 1)
        if start >= end:
            return
        with open(shard_name, "rb") as f:
            f.seek(offs[start])
            for _ in range(start, end):
                yield f.readline().rstrip(b"\r\n")


class CSVDataReader(TextLineDataReader):
    """CSV with a header row: column names surface through `metadata` so
    dataset_fn parsers can address fields by name instead of position
    (reference parity: the CSV reader used by the census/wide-deep configs).
    Records are the raw data lines; parsing stays in the model's dataset_fn.
    """

    def __init__(
        self,
        path: str,
        delimiter: str = ",",
        columns: Optional[List[str]] = None,
        **params,
    ):
        params.pop("skip_header", None)
        super().__init__(path, skip_header=True, **params)
        self._delimiter = delimiter

        def header_of(fname: str) -> List[str]:
            with open(fname, "rb") as f:
                header = f.readline().decode().rstrip("\r\n")
            return [c.strip() for c in header.split(delimiter)]

        first_header = header_of(self._files[0])
        # Explicit columns= RENAMES the schema (reference behavior); the
        # physical headers must still agree file-to-file: a directory mixing
        # column orders would otherwise be silently misparsed — positions,
        # not names, address fields after the header is skipped (round-3 fix
        # of the advisor's round-1 finding).
        for fname in self._files[1:]:
            cols = header_of(fname)
            if cols != first_header:
                raise ValueError(
                    f"CSV header mismatch: {fname} has columns {cols}, "
                    f"but {self._files[0]} has {first_header}"
                )
        self._columns = list(columns) if columns is not None else first_header

    @property
    def metadata(self) -> Dict:
        return {"columns": self._columns, "delimiter": self._delimiter}


class FixedLenBinDataReader(AbstractDataReader):
    """Fixed-width binary records (e.g. .cbin Criteo shards written by
    parsing.convert_criteo_tsv). Shard = file; record i lives at byte
    i*record_bytes — no index to build or load, seeks are pure arithmetic,
    and `read_block` hands whole spans to blob-accepting parsers as one
    contiguous read (the memcpy-speed half of the binary fast path)."""

    # stateless: every read_block opens its own handle
    THREAD_SAFE_SPANS = True

    def __init__(self, path: str, record_bytes: int, suffix: str = ".cbin", **_):
        if record_bytes <= 0:
            raise ValueError("record_bytes must be positive")
        self._rb = int(record_bytes)
        # dir/glob listings filter to `suffix`: a stray _SUCCESS marker or
        # README in the shard directory must neither fail construction nor
        # (worse, if its size divides record_bytes) be reinterpreted as
        # training records; an explicit single-file path is taken verbatim
        self._files = resolve_files(path, require_suffix=suffix)
        if not self._files:
            raise FileNotFoundError(
                f"no input files match {path!r} (suffix {suffix!r})"
            )
        for f in self._files:
            if os.path.getsize(f) % self._rb:
                raise ValueError(
                    f"{f}: size {os.path.getsize(f)} not a multiple of "
                    f"record_bytes={self._rb}"
                )

    @property
    def metadata(self) -> Dict:
        return {"record_bytes": self._rb}

    def create_shards(self) -> List[Shard]:
        return [(f, 0, os.path.getsize(f) // self._rb) for f in self._files]

    def read_block(self, shard_name: str, start: int, end: int) -> bytes:
        with open(shard_name, "rb") as f:
            f.seek(start * self._rb)
            return f.read((end - start) * self._rb)

    def read_span(self, shard_name: str, start: int, end: int) -> List[bytes]:
        blob = self.read_block(shard_name, start, end)
        return [blob[i: i + self._rb] for i in range(0, len(blob), self._rb)]

    def read_records(self, shard_name: str, start: int, end: int) -> Iterator[bytes]:
        yield from self.read_span(shard_name, start, end)


class ODPSDataReader(AbstractDataReader):
    """ODPS/MaxCompute table reader (reference parity: ODPSDataReader —
    table slices as shards, credentials from the environment).

    Needs the `pyodps` package (`odps`), not installed in this sandbox, so
    construction raises a clear error unless it's importable. Auth comes from
    env like the reference: ODPS_PROJECT_NAME / ODPS_ACCESS_ID /
    ODPS_ACCESS_KEY / ODPS_ENDPOINT. Records are yielded as the reader's row
    tuples encoded CSV-style, keeping the dataset_fn contract byte-oriented.

    Verification status: exercised only against a MOCKED pyodps
    (tests/test_data.py) — this sandbox has no MaxCompute credentials, so
    the reader has never run against a live table. The mock mirrors the
    open_reader/tunnel API surface, but treat the first real-table run as
    unproven territory and validate row counts before trusting a job.
    """

    ENV_VARS = (
        "ODPS_PROJECT_NAME", "ODPS_ACCESS_ID", "ODPS_ACCESS_KEY", "ODPS_ENDPOINT"
    )

    def __init__(
        self,
        table: str,
        columns: Optional[List[str]] = None,
        records_per_shard: int = 10000,
        partition: Optional[str] = None,
        **_,
    ):
        try:
            import odps  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "ODPSDataReader needs the pyodps package (`pip install pyodps`); "
                "it is not available in this environment"
            ) from e
        missing = [v for v in self.ENV_VARS if not os.environ.get(v)]
        if missing:
            raise ValueError(f"ODPS credentials missing from env: {missing}")
        from odps import ODPS

        self._odps = ODPS(
            os.environ["ODPS_ACCESS_ID"],
            os.environ["ODPS_ACCESS_KEY"],
            project=os.environ["ODPS_PROJECT_NAME"],
            endpoint=os.environ["ODPS_ENDPOINT"],
        )
        self._table = self._odps.get_table(table)
        self._partition = partition
        self._columns = columns
        self._per_shard = int(records_per_shard)

    def _count(self) -> int:
        with self._table.open_reader(partition=self._partition) as r:
            return r.count

    def create_shards(self) -> List[Shard]:
        n = self._count()
        return [
            (self._table.name, s, min(s + self._per_shard, n))
            for s in range(0, n, self._per_shard)
        ]

    @property
    def metadata(self) -> Dict:
        cols = self._columns or [c.name for c in self._table.table_schema.columns]
        return {"columns": cols, "table": self._table.name}

    def read_records(self, shard_name: str, start: int, end: int) -> Iterator[bytes]:
        import csv
        import io

        with self._table.open_reader(partition=self._partition) as r:
            for row in r[start:end]:
                values = (
                    [row[c] for c in self._columns] if self._columns else list(row.values)
                )
                # proper CSV quoting: string fields may contain the delimiter
                buf = io.StringIO()
                csv.writer(buf, lineterminator="").writerow(
                    ["" if v is None else str(v) for v in values]
                )
                yield buf.getvalue().encode()


class SyntheticDataReader(AbstractDataReader):
    """Deterministic synthetic records for the parity workloads.

    kind: mnist | cifar10 | imagenet224 | criteo | census
    Record formats match the corresponding model_zoo dataset_fn parsers, and
    generation is pure f(record_index), so any worker reading any span gets
    identical bytes — which makes exactly-once accounting testable.
    """

    # pure f(record_index): no shared mutable state across reads
    THREAD_SAFE_SPANS = True

    def __init__(
        self,
        kind: str = "mnist",
        num_records: int = 60000,
        num_shards: int = 4,
        seed: int = 1234,
        vocab: int = 256,
        seq_len: int = 128,
        **_,
    ):
        self._kind = kind
        self._n = int(num_records)
        self._num_shards = max(1, int(num_shards))
        self._seed = seed
        self._vocab = int(vocab)
        self._seq_len = int(seq_len)

    def create_shards(self) -> List[Shard]:
        per = (self._n + self._num_shards - 1) // self._num_shards
        return [
            (f"synthetic-{self._kind}-{i}", i * per, min((i + 1) * per, self._n))
            for i in range(self._num_shards)
            if i * per < self._n
        ]

    @property
    def metadata(self) -> Dict:
        return {
            "kind": self._kind, "num_records": self._n,
            "vocab": self._vocab, "seq_len": self._seq_len,
        }

    def _record(self, idx: int) -> bytes:
        rng = np.random.RandomState((self._seed + idx) % (2**31))
        if self._kind == "mnist":
            label = idx % 10
            img = (rng.rand(784) * 25 + label * 23).astype(np.uint8)
            return bytes([label]) + img.tobytes()
        if self._kind == "cifar10":
            label = idx % 10
            img = (rng.rand(32 * 32 * 3) * 25 + label * 23).astype(np.uint8)
            return bytes([label]) + img.tobytes()
        if self._kind == "imagenet224":
            label = idx % 1000
            img = (rng.rand(64) * 255).astype(np.uint8)  # seed block; parser tiles
            return int(label).to_bytes(2, "little") + img.tobytes()
        if self._kind == "criteo":
            label = rng.randint(0, 2)
            dense = rng.randint(0, 100, 13) + label * 40
            cats = rng.randint(0, 1 << 20, 26) + label
            return (
                str(label)
                + "\t" + "\t".join(str(d) for d in dense)
                + "\t" + "\t".join(format(c, "x") for c in cats)
            ).encode()
        if self._kind == "lm":
            # Learnable token sequences: mostly-deterministic affine bigram
            # process t[i+1] = (5*t[i] + 3) % vocab with 10% noise tokens.
            # vocab/seq_len come from reader params (metadata carries them).
            vocab = self._vocab
            T = self._seq_len
            toks = np.empty(T + 1, np.uint16)
            toks[0] = rng.randint(0, vocab)
            noise = rng.rand(T) < 0.1
            rand_toks = rng.randint(0, vocab, T)
            for t in range(T):
                toks[t + 1] = rand_toks[t] if noise[t] else (5 * int(toks[t]) + 3) % vocab
            return toks.tobytes()
        if self._kind == "census":
            label = rng.randint(0, 2)
            age = 25 + label * 15 + rng.randint(0, 10)
            occ = f"occ{rng.randint(0, 10) + label * 3}"
            row = (
                f"{age}, Private, 1, Bachelors, {8 + label * 4}, Married, {occ}, "
                f"Husband, White, Male, {label * 4000}, 0, {35 + label * 10}, "
                f"United-States, {'>50K' if label else '<=50K'}"
            )
            return row.encode()
        raise ValueError(f"unknown synthetic kind {self._kind!r}")

    def read_records(self, shard_name: str, start: int, end: int) -> Iterator[bytes]:
        for i in range(start, min(end, self._n)):
            yield self._record(i)


def create_data_reader(
    data_path: str, reader_name: str = "", **params
) -> AbstractDataReader:
    """Factory (reference parity: create_data_reader). `synthetic://kind?n=N`
    and plain paths are recognized; reader_name overrides inference."""
    if data_path.startswith("synthetic://"):
        rest = data_path[len("synthetic://"):]
        kind, _, qs = rest.partition("?")
        opts = dict(p.split("=", 1) for p in qs.split("&") if "=" in p)
        aliases = {"seq": "seq_len"}  # the zoo docs use the short form
        extra = {
            aliases.get(k, k): int(float(v))
            for k, v in opts.items() if k not in ("n", "shards")
        }
        return SyntheticDataReader(
            kind=kind or "mnist",
            # int(float(...)) so scientific notation ("n=1e6") works
            num_records=int(float(opts.get("n", params.pop("num_records", 60000)))),
            num_shards=int(float(opts.get("shards", params.pop("num_shards", 4)))),
            **{**params, **extra},
        )
    if data_path.startswith("odps://"):
        # odps://<table>[#partition] — project comes from env, like the
        # reference's client-side table addressing
        rest = data_path[len("odps://"):]
        table, _, part = rest.partition("#")
        return ODPSDataReader(table, partition=part or None, **params)
    if not reader_name:
        def _has(ext):
            return data_path.endswith(ext) or (
                os.path.isdir(data_path)
                and any(f.endswith(ext) for f in os.listdir(data_path))
            )
        # .csv paths stay on textline: only an explicit reader_name="csv"
        # implies a header row to skip
        reader_name = (
            "recordio" if _has(".rio")
            else "criteo_bin" if _has(".cbin")
            else "textline"
        )
    name = reader_name
    if name in ("textline", "tsv"):
        return TextLineDataReader(data_path, **params)
    if name == "csv":
        return CSVDataReader(data_path, **params)
    if name in ("bin", "fixed_bin"):
        return FixedLenBinDataReader(data_path, **params)
    if name == "criteo_bin":
        from elasticdl_tpu_torch.data import parsing

        params.setdefault(
            "record_bytes",
            parsing.criteo_bin_record_bytes(
                int(params.pop("num_dense", 13)), int(params.pop("num_cat", 26))
            ),
        )
        return FixedLenBinDataReader(data_path, **params)
    if name == "odps":
        return ODPSDataReader(data_path, **params)
    if name == "recordio":
        from elasticdl_tpu_torch.data.recordio import RecordIODataReader

        return RecordIODataReader(data_path, **params)
    raise ValueError(f"unknown data reader {name!r}")
