"""Data substrate: synthetic world generator.

(The training pipelines are not ported yet: ROADMAP.md, queue A item A9.)"""
from .synthetic import (generate_world, roads_schema, observations_schema,
                        route_requests_schema, trips_schema, city_region,
                        CITIES, BAY_AREA)

__all__ = ["generate_world", "roads_schema", "observations_schema",
           "route_requests_schema", "trips_schema", "city_region",
           "CITIES", "BAY_AREA"]
