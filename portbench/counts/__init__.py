"""Operation counts of the configurations, from shapes."""
