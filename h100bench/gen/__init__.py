"""Seeded generators of the benchmark's inputs."""
