"""Launch entry points of the port: serving (``serve``) and training
(``train``)."""
