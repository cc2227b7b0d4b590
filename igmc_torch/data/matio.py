"""MATLAB v7.3 (HDF5) field reader for the Monti et al. rating datasets.

Port of igmc_tpu/data/matio.py without h5py: the file is read by
data/hdf5.py. A named field is either a MATLAB sparse matrix (a group of
`data`/`ir`/`jc`, CSC layout) or a dense matrix stored column-major, which
is transposed to match NumPy's row-major view.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .hdf5 import HDF5File


def load_matlab_file(path_file: str, name_field: str):
    """One field of a MATLAB v7.3 .mat file: a float32 scipy CSC matrix for
    a sparse field, else a float32 ndarray."""
    with HDF5File(path_file) as db:
        if db.is_group(name_field):
            parts = db.group(name_field)
            if "ir" not in parts:
                raise ValueError(f"{path_file}: group {name_field!r} is not a "
                                 f"MATLAB sparse matrix (no ir)")
            return sp.csc_matrix((parts["data"], parts["ir"], parts["jc"])
                                 ).astype(np.float32)
        return db[name_field].astype(np.float32).T
