"""The port's copy of what its processes write of the job history."""
