"""Native host library (SA-IS suffix sorting, FASTA parsing)."""
