from .model import (Model, exact_solution, find_field, hermitian_dot,
                    real_inner, trace)

__all__ = ["Model", "exact_solution", "find_field", "hermitian_dot",
           "real_inner", "trace"]
