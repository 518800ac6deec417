"""Traffic drivers: ``<kind>.py`` runs a traffic file of that ``kind``
(``run(ctx) -> run.Run``)."""
