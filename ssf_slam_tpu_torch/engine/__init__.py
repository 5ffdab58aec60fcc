"""The SLAM step, the fused network-in-the-loop step and their sequence
runners."""
