"""Fleet build planning: training buckets (the naive strategy)."""
