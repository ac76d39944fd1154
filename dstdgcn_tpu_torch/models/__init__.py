from .dstdgcn import DSTDGCN, get_model
from .layers import (DSTDGC, DSTDGCB, Dense, JointBatchNorm, PReLU,
                     STGCNNLayer)

__all__ = ["DSTDGCN", "get_model", "DSTDGC", "DSTDGCB", "Dense",
           "JointBatchNorm", "PReLU", "STGCNNLayer"]
