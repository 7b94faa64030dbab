"""The launch layer's control-plane pieces the eager core needs: the HMAC
secrets (``secret``) and the authenticated TCP wire (``network``)."""
