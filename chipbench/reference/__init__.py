"""What the families' plain references share (``moe_lm``) and the serving
state the comparison works out again (``serving_state``, ``residency``).
They import nothing of the program; each family's own forward is in
``chipbench/families/``."""
