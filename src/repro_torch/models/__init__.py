from .convert import params_from_reference
from .model import COMPUTE_DTYPE, Model, build_model
