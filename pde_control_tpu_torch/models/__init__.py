"""Networks: the CFE conv net and the OP U-net."""
