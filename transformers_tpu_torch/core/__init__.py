"""Checkpoint IO and leaf modules of the port."""
