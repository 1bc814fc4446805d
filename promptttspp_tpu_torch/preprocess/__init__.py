"""Offline feature preprocessing of the port."""
