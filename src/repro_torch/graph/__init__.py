"""Web-graph containers, generators, reorderings and the Google operator."""
from .csr import CSRGraph, TransitionT, pt_matvec, pt_matvec_block
from .generate import (powerlaw_webgraph, stanford_web_replica,
                       small_test_graph, cycle_graph)
from .google import GoogleOperator, exact_pagerank
from .reorder import reorder_operator
