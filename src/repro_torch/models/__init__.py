from .convert import cache_from_reference, params_from_reference
from .model import COMPUTE_DTYPE, Model, build_model
