from .parsing import parse_equations
