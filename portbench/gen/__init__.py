"""General traffic generators; a traffic file names one (`"generator"`)
and gives its parameters."""
