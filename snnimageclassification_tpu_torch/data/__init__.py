"""Data pipeline: dataset loading, array loaders, the device-resident cache
and the on-device encode configs."""
from .datasets import (  # noqa: F401
    ArrayDataLoader,
    DatasetId,
    EncodeConfig,
    get_dataloaders,
    load_raw,
    read_idx,
)
from .device_cache import DeviceDataCache, pad_rows  # noqa: F401
