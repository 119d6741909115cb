from learningorchestra_tpu_torch.models.registry import (  # noqa: F401
    CLASSIFIERS, get_trainer)
from learningorchestra_tpu_torch.models.builder import ModelBuilder  # noqa: F401
