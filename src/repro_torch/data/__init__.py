"""Data substrate: synthetic world generator + training pipelines."""
from .synthetic import (generate_world, roads_schema, observations_schema,
                        route_requests_schema, trips_schema, city_region,
                        CITIES, BAY_AREA)
from .pipeline import TokenPipeline, TrainingDataset, WflBatcher

__all__ = ["generate_world", "roads_schema", "observations_schema",
           "route_requests_schema", "trips_schema", "city_region",
           "CITIES", "BAY_AREA", "TokenPipeline", "TrainingDataset",
           "WflBatcher"]
