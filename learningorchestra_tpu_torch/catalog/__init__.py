# pyarrow is imported eagerly on the importing thread (see the package
# __init__ for why a first import on a worker thread is avoided).
import pyarrow  # noqa: F401
import pyarrow.parquet  # noqa: F401

from learningorchestra_tpu_torch.catalog.dataset import (  # noqa: F401,E402
    ChunkCorrupt, Dataset, Metadata)
from learningorchestra_tpu_torch.catalog.store import DatasetStore  # noqa: F401,E402
