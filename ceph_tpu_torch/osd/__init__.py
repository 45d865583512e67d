"""The OSDMap above CRUSH and the batched PG→OSD pipeline (`PoolMapper`)."""
