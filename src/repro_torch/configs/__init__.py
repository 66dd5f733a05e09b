"""Workload configs of the port."""
from .pagerank import SMALL, STANFORD, PageRankConfig
