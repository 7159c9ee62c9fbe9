from instruct_jax.tetra.combinatorics import build_class_tables, ClassTables

__all__ = ["build_class_tables", "ClassTables"]
