"""Control: the PDE plugin, sequence builders and the training harness."""
