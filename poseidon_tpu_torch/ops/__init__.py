"""Solver ops: transport form, dense auction, the device-resident round."""
