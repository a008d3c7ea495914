"""Found-policy archives and the policy codec."""
