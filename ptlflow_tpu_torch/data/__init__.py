"""Datasets, the dataset-selection module and dummy dataset writers of the
PyTorch port (``ptlflow_tpu/data``), reading images without OpenCV."""

from .datasets import (  # noqa: F401
    BaseFlowDataset, AutoFlowDataset, FlyingChairsDataset,
    FlyingChairs2Dataset, FlyingThings3DDataset,
    FlyingThings3DSubsetDataset, Hd1kDataset, KittiDataset, KubricDataset,
    MiddleburyDataset, MiddleburySTDataset, MonkaaDataset, SintelDataset,
    SpringDataset, TartanAirDataset, ViperDataset,
)
from .datamodule import (  # noqa: F401
    FlowDataModule, SimpleLoader, ConcatDataset, RepeatedDataset,
    numpy_collate, make_divisible,
)
from . import dummy_datasets  # noqa: F401
