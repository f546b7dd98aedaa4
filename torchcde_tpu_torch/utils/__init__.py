from .misc import cheap_stack, stack_endpoints, validate_input_path
from .observability import annotate, load_checkpoint, save_checkpoint, trace
from .tuple_control import TupleControl

__all__ = ["TupleControl", "annotate", "cheap_stack", "load_checkpoint", "save_checkpoint",
           "stack_endpoints", "trace", "validate_input_path"]
