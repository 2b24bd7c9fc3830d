"""Launch layer: the single-device training driver (``launch.train``)."""
