"""learningorchestra_tpu_torch — the framework's PyTorch + CUDA package.

The same named-dataset catalog, preprocessing, five-classifier model
builder (lr/dt/rf/gb/nb, plus the mlp) and hyperparameter search as
``learningorchestra_tpu``, run as PyTorch tensor code on one CUDA
device, with the tree-fitting hot loops as hand-written CUDA kernels
(``csrc/tree_kernels.cu``). Entry points take
an explicit ``device`` and default to ``"cuda"``; ``device="cpu"`` runs
every kernel's plain PyTorch version instead.
"""

__version__ = "0.1.0"

from learningorchestra_tpu_torch.config import Settings, settings  # noqa: F401
# pyarrow is imported eagerly, on the thread that first imports the
# catalog, as the catalog's chunk files are parquet: its static
# initialization on a worker thread of a process that already loaded a
# large native runtime has been seen to corrupt the process.
import pyarrow  # noqa: F401,E402
import pyarrow.parquet  # noqa: F401,E402

from learningorchestra_tpu_torch.catalog.dataset import (  # noqa: F401,E402
    ChunkCorrupt, Dataset, Metadata)
from learningorchestra_tpu_torch.catalog.store import DatasetStore  # noqa: F401,E402
