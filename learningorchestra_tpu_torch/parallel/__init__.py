from learningorchestra_tpu_torch.parallel.runtime import (  # noqa: F401
    DeviceRuntime, host_rows)
