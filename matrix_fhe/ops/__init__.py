"""Compute-path ops. Import submodules directly (e.g.
`from matrix_fhe.ops import ntt`); higher-level modules (crt, ntt, wcrt)
depend on matrix_fhe.tables, which itself uses modmath — keep this
__init__ light to avoid cycles."""

from . import modmath, modmatmul  # noqa: F401
