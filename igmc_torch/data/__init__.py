from .loaders import load_data, map_data, raw_data_dir
from .splits import SplitData, create_trainvaltest_split

__all__ = ["SplitData", "create_trainvaltest_split", "load_data", "map_data",
           "raw_data_dir"]
