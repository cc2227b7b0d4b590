from .loaders import load_data, map_data, raw_data_dir
from .matio import load_matlab_file
from .splits import (MONTI_DATASETS, SplitData, create_trainvaltest_split,
                     load_data_monti, load_official_trainvaltest_split)
from .synthetic import (synthesize_ratings, write_ml1m_format, write_ml25m_format,
                        write_ml100k_format)

__all__ = ["MONTI_DATASETS", "SplitData", "create_trainvaltest_split",
           "load_data", "load_data_monti", "load_matlab_file",
           "load_official_trainvaltest_split", "map_data", "raw_data_dir",
           "synthesize_ratings", "write_ml100k_format", "write_ml1m_format",
           "write_ml25m_format"]
