from .misc import cheap_stack, stack_endpoints, validate_input_path

__all__ = ["cheap_stack", "stack_endpoints", "validate_input_path"]
