from .engine import IO_SUMMARY_KEYS, ServeEngine, StepStats
from .sparse_exec import SPARSE_METHODS, WBITS_CHOICES, SparseExecution
